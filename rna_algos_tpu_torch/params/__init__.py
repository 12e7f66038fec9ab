"""Model parameters: the port's own copy of ``rna_algos_tpu.params``
(CONTRAfold v2.02 and Turner 2004 tables, the ViennaRNA ``.par`` drop-in,
and the CONTRAlign v2.01 pair-HMM scores that come with the Durbin path)."""

from . import turner
from . import contrafold
from . import contralign
from . import vienna
from .contrafold import build_fold_score_sets, parse_contrafold_params
from .contralign import build_align_scores, parse_contralign_params
from .vienna import load_turner_params, parse_vienna_par

__all__ = [
    "turner",
    "contrafold",
    "contralign",
    "vienna",
    "build_fold_score_sets",
    "parse_contrafold_params",
    "build_align_scores",
    "parse_contralign_params",
    "load_turner_params",
    "parse_vienna_par",
]
