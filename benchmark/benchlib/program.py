"""The system under test: the port's ``FoldEngine`` and, where the traffic
asks for structures, its ``centroid_structures``, built from a
configuration's parameter arrays.  Nothing else of the port is used."""

import contextlib

import torch

# Launch counters of every inside-pass kernel: one launch a run of the
# fold (the prefix seed's run, the first run and each re-run).
INSIDE_COUNTERS = (
    ("ops.pallas_fold_prob8", ("inside_launches", "turner_inside_launches")),
    ("ops.pallas_fold_long", ("contra_inside_long_launches",
                              "turner_inside_long_launches")),
    ("ops.pallas_fold", ("contra_inside_log_launches",
                         "turner_inside_log_launches")),
    ("ops.fold_scan", ("inside_launches",)),
)


def _span(name, on):
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function("bench." + name)


class Program:
    """One configuration's engine on ``device``."""

    def __init__(self, config, params, device):
        from rna_algos_tpu_torch.parallel.runner import FoldEngine

        model = config["model"]
        if model == "contra":
            from rna_algos_tpu_torch.params import build_fold_score_sets

            self.engine = FoldEngine(
                uses_contra_model=True, fss=build_fold_score_sets(raw=params),
                device=device, numerics=config["numerics"])
        elif model == "turner":
            from rna_algos_tpu_torch.params import turner

            turner.set_tables({k: params[k] for k in turner.TABLE_NAMES})
            self.engine = FoldEngine(uses_contra_model=False, device=device,
                                     numerics=config["numerics"])
        else:
            raise ValueError(f"unknown model {model!r}")
        self.device = self.engine.device

    def call(self, seqs, gammas=None, timer=None, spans=False):
        """One request: the (bpp, presence) of every sequence and, with
        ``gammas``, the dot-brackets {gamma: [structure per sequence]}."""
        from rna_algos_tpu_torch.models.centroid import centroid_structures

        with _span("fold_batch", spans):
            results = self.engine.fold_batch(seqs)
        structures = None
        if gammas is not None:
            with _span("centroid", spans):
                structures = centroid_structures(
                    [(b, p, len(s)) for (b, p), s in zip(results, seqs)],
                    gammas, self.device, timer=timer)
        return results, structures


def inside_runs():
    """The inside-pass launches counted so far, over every kernel tier."""
    import importlib

    total = 0
    for mod, names in INSIDE_COUNTERS:
        m = importlib.import_module("rna_algos_tpu_torch." + mod)
        total += sum(getattr(m, n).count for n in names)
    return total
