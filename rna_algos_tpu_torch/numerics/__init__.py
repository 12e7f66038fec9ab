"""Log-space numerics (``rna_algos_tpu.numerics``): the reference's
piecewise-cubic ``ln_exp_1p`` / ``expf``, the pairwise log-add
``lse_pair``, its streaming ``lse_accumulate`` and the balanced-tree
``lse_reduce``, with the numerics mode passed as an argument."""

from .logsumexp import (MODES, check_mode, expf, ln_exp_1p, lse_accumulate,
                        lse_pair, lse_reduce)

__all__ = ["MODES", "check_mode", "expf", "ln_exp_1p", "lse_accumulate",
           "lse_pair", "lse_reduce"]
