"""Model parameters: the port's own copy of ``rna_algos_tpu.params``
(CONTRAfold v2.02 and Turner 2004 tables, the ViennaRNA ``.par`` drop-in).
The pair-HMM weights (``contralign``) come with the Durbin path."""

from . import turner
from . import contrafold
from . import vienna
from .contrafold import build_fold_score_sets, parse_contrafold_params
from .vienna import load_turner_params, parse_vienna_par

__all__ = [
    "turner",
    "contrafold",
    "vienna",
    "build_fold_score_sets",
    "parse_contrafold_params",
    "load_turner_params",
    "parse_vienna_par",
]
