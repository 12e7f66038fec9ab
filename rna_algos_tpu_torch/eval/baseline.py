"""Independent threshold estimator: the eval's comparison arm.

The reference benchmarks its gamma-centroid estimator against the external
CentroidFold tool (`reference/scripts/run_ss_estimation_programs.py:
58-68,89-99`) so fig_1 compares two independent estimators per model.  That
tool is not installable here, so the second arm is an independently
implemented estimator over the same BPPs: the
classic *threshold* estimator — select pairs with p(i, j) > 1 / (gamma + 1)
greedily by descending probability, rejecting base-sharing or crossing
conflicts.  For the gamma-centroid loss this threshold rule is the
per-pair-optimal decision ignoring nesting interactions, which the greedy
conflict resolution then restores — a genuinely different algorithm (NumPy
greedy, no DP, no device code) whose agreement/divergence from the MEA DP
is exactly the comparative signal fig_1 carries.
"""

import numpy as np


def threshold_pairs(bpp, n, gamma):
    """Greedy conflict-free pair selection at threshold 1/(gamma+1)."""
    thr = 1.0 / (gamma + 1.0)
    iu, ju = np.triu_indices(n, k=1)
    ps = np.asarray(bpp)[iu, ju]
    keep = ps > thr
    order = np.argsort(-ps[keep], kind="stable")
    cand = list(zip(iu[keep][order], ju[keep][order]))
    used = np.zeros(n, dtype=bool)
    chosen = []
    for i, j in cand:
        if used[i] or used[j]:
            continue
        crossing = any((a < i < b < j) or (i < a < j < b) for a, b in chosen)
        if crossing:
            continue
        used[i] = used[j] = True
        chosen.append((int(i), int(j)))
    return sorted(chosen)


def write_gamma_file_threshold(path, results, gamma):
    """Same file layout as cli.centroid_fold.write_gamma_file."""
    from ..utils.output import fold_str

    lines = []
    n_records = len(results)
    for rna_id, (bpp, _presence, n) in enumerate(results):
        pairs = threshold_pairs(bpp, n, gamma)
        tail = "\n" if rna_id < n_records - 1 else ""
        lines.append(f">{rna_id}\n" + fold_str(pairs, n) + tail)
    with open(path, "w") as f:
        f.write("".join(lines))
