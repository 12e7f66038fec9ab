"""Accuracy-curve figures for the eval pipeline.

Re-creation of the reference's plotting stage
(`reference/scripts/get_stats_of_ss_estimation_programs.py:112-152`,
which renders `assets/images_fixed/fig_1.png`): a 2x2 panel of
precision-recall, ROC, F1-vs-gamma, and MCC-vs-gamma curves over the
gamma grid, one series per estimator/model.

Input is the ``curves`` mapping produced by :func:`.pipeline.compute_stats`
(model -> list of per-gamma dicts with ppv/sens/fpr/f1/mcc); the JSON report
written next to the figure is the table view of the same data.

Chart conventions: one axis per panel, fixed entity->color assignment
(color follows the model, not its position in the list), 2px lines,
recessive grid, direct end-of-line labels plus a shared legend.
"""

import math
import os

# Fixed categorical assignment (validated 3-slot palette; a 4th+ model
# reuses the documented slots 4+ but the standard eval compares <= 3).
_SLOT_COLORS = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4"]
_KNOWN_SLOTS = {"turner": 0, "contra": 1, "centroidfold": 2}

_TEXT = "#0b0b0b"
_TEXT_2 = "#52514e"
_GRID = "#e4e3e0"
_SURFACE = "#fcfcfb"


def _color_for(model, fallback_idx):
    idx = _KNOWN_SLOTS.get(model.lower(), fallback_idx)
    return _SLOT_COLORS[idx % len(_SLOT_COLORS)]


def _style_axis(ax, title, xlabel, ylabel):
    ax.set_facecolor(_SURFACE)
    ax.set_title(title, fontsize=11, color=_TEXT, pad=8)
    ax.set_xlabel(xlabel, fontsize=9, color=_TEXT_2)
    ax.set_ylabel(ylabel, fontsize=9, color=_TEXT_2)
    ax.grid(True, color=_GRID, linewidth=0.6)
    ax.tick_params(colors=_TEXT_2, labelsize=8)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color(_GRID)


def _finite_xy(xs, ys):
    pts = [
        (x, y)
        for x, y in zip(xs, ys)
        if not (math.isnan(x) or math.isnan(y))
    ]
    return [p[0] for p in pts], [p[1] for p in pts]


def plot_curves(curves, out_path, title=None):
    """Write the 2x2 accuracy figure (fig_1 analog) to ``out_path``.

    Args:
      curves: {model: [{gamma, ppv, sens, fpr, f1, mcc}, ...]}.
      out_path: output image path (.png/.svg by extension).
      title: optional figure suptitle.

    Returns the output path. Requires matplotlib (raises ImportError
    otherwise; the JSON report from the pipeline is the fallback artifact).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(9, 7.2), facecolor=_SURFACE)
    (ax_pr, ax_roc), (ax_f1, ax_mcc) = axes

    _style_axis(ax_pr, "Precision - recall", "Sensitivity (recall)", "PPV (precision)")
    _style_axis(ax_roc, "ROC", "False-positive rate", "Sensitivity")
    _style_axis(ax_f1, "F1 over the gamma grid", "log2(gamma)", "F1")
    _style_axis(ax_mcc, "MCC over the gamma grid", "log2(gamma)", "MCC")

    for k, (model, rows) in enumerate(curves.items()):
        color = _color_for(model, k)
        gammas = [r["gamma"] for r in rows]
        lg = [math.log2(g) for g in gammas]
        line_kw = dict(
            color=color, linewidth=2, marker="o", markersize=5,
            markerfacecolor=color, markeredgecolor=_SURFACE,
            markeredgewidth=0.8, label=model,
        )
        xs, ys = _finite_xy([r["sens"] for r in rows], [r["ppv"] for r in rows])
        ax_pr.plot(xs, ys, **line_kw)
        xs, ys = _finite_xy([r["fpr"] for r in rows], [r["sens"] for r in rows])
        ax_roc.plot(xs, ys, **line_kw)
        xs, ys = _finite_xy(lg, [r["f1"] for r in rows])
        ax_f1.plot(xs, ys, **line_kw)
        if xs:
            # direct label at the line end, in text ink (identity also in
            # the legend; the colored line carries the hue)
            ax_f1.annotate(
                model, (xs[-1], ys[-1]), textcoords="offset points",
                xytext=(6, 0), fontsize=8, color=_TEXT_2,
            )
        xs, ys = _finite_xy(lg, [r["mcc"] for r in rows])
        ax_mcc.plot(xs, ys, **line_kw)

    for ax in (ax_pr, ax_roc):
        ax.set_xlim(left=0)
        ax.set_ylim(bottom=0)

    if len(curves) >= 2:
        handles, labels = ax_f1.get_legend_handles_labels()
        fig.legend(
            handles, labels, loc="lower center", ncol=max(1, len(labels)),
            frameon=False, fontsize=9, labelcolor=_TEXT,
        )
    if title:
        fig.suptitle(title, fontsize=12, color=_TEXT)
    fig.tight_layout(rect=(0, 0.05, 1, 1 if title is None else 0.96))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=150, facecolor=_SURFACE)
    plt.close(fig)
    return out_path
