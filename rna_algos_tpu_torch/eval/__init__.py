"""Accuracy evaluation (``rna_algos_tpu.eval``): the seed set, the family
compilation, the two estimators' structure files, the statistics and the
figure, on the port's ``FoldEngine``.  ``pipeline`` is imported on first
use, so ``python -m rna_algos_tpu_torch.eval.pipeline`` runs it once."""

import importlib

from . import stats
from . import rfam

__all__ = ["stats", "rfam", "pipeline"]


def __getattr__(name):
    if name == "pipeline":
        return importlib.import_module(f"{__name__}.pipeline")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
