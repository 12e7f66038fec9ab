"""Model parameters carried across: numpy tables -> torch tensors.

Counterparts of ``rna_algos_tpu.ops.scores.contra_table_pytree`` and
``turner_table_pytree``, and of the align-score dict the JAX
``AlignEngine`` puts on the device.  JAX silently downcasts float64 input
to float32 (x64 off); torch keeps float64, so the cast is explicit here.
"""

import numpy as np
import torch

from .params import turner as T


def contra_tables(fss, device):
    """FoldScoreSets (dict of numpy arrays or scalars) -> dict of float32
    tensors on ``device``."""
    return {
        k: torch.as_tensor(np.asarray(v, dtype=np.float32), device=device)
        for k, v in fss.items()
    }


ALIGN_SCALARS = ("match2match_score", "match2insert_score",
                 "insert_extend_score", "insert_switch_score",
                 "init_match_score", "init_insert_score")


def align_tables(scores, device):
    """CONTRAlign align-score dict (``params.build_align_scores()`` or any
    parsed parameter file: numpy arrays and scalars) -> float32 tensors on
    ``device``: the (5, 5) ``match_scores`` and (5,) ``insert_scores``
    tables, each with its zero PSEUDO row, and the six 0-d scalars."""
    out = {
        k: torch.as_tensor(np.asarray(scores[k], dtype=np.float32),
                           device=device)
        for k in ("match_scores", "insert_scores") + ALIGN_SCALARS
    }
    if out["match_scores"].shape != (5, 5) or out["insert_scores"].shape != (5,):
        raise ValueError("align scores: expected (5, 5) match and (5,) "
                         "insert tables")
    return out


# turner_table_pytree key -> params.turner table name
TURNER_KEYS = {
    "stack": "STACK_SCORES",
    "hairpin_init": "HAIRPIN_SCORES_INIT",
    "bulge_init": "BULGE_SCORES_INIT",
    "interior_init": "INTERIOR_SCORES_INIT",
    "int_1x1": "INTERIOR_SCORES_1X1",
    "int_1x2": "INTERIOR_SCORES_1X2",
    "int_2x2": "INTERIOR_SCORES_2X2",
    "tm_hairpin": "TERMINAL_MISMATCH_SCORES_HAIRPIN",
    "tm_interior": "TERMINAL_MISMATCH_SCORES_INTERIOR",
    "tm_1xmany": "TERMINAL_MISMATCH_SCORES_1XMANY",
    "tm_2x3": "TERMINAL_MISMATCH_SCORES_2X3",
    "tm_multibranch": "TERMINAL_MISMATCH_SCORES_MULTIBRANCH",
    "dangle5": "DANGLING_SCORES_5PRIME",
    "dangle3": "DANGLING_SCORES_3PRIME",
    "special_seqs": "HAIRPIN_SPECIAL_SEQS",
    "special_lens": "HAIRPIN_SPECIAL_LENS",
    "special_scores": "HAIRPIN_SPECIAL_SCORES",
    "ninio_coeff": "NINIO_COEFF",
    "ninio_max": "NINIO_MAX",
    "augu_penalty": "HELIX_AUGU_END_PENALTY",
    "init_multibranch_base": "INIT_MULTIBRANCH_BASE",
    "coeff_num_branches": "COEFF_NUM_BRANCHES",
    "coeff_hairpin_extrap": "COEFF_HAIRPIN_LEN_EXTRAPOLATION",
}
TURNER_INT_KEYS = ("special_seqs", "special_lens")


def turner_tables(device, tables=None):
    """Turner 2004 tables as tensors on ``device``: float tables float32,
    ``special_seqs`` / ``special_lens`` int64.

    ``tables`` defaults to ``params.turner.active_tables()``, so the
    ``RNA_ALGOS_TURNER_PARAMS`` drop-in applies to both packages."""
    tabs = T.active_tables() if tables is None else tables
    out = {}
    for key, name in TURNER_KEYS.items():
        dt = np.int64 if key in TURNER_INT_KEYS else np.float32
        out[key] = torch.as_tensor(np.asarray(tabs[name], dtype=dt),
                                   device=device)
    return out
