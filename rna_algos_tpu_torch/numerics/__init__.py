"""Log-space numerics (``rna_algos_tpu.numerics``): the reference's
piecewise-cubic ``ln_exp_1p`` / ``expf`` and the pairwise log-add
``lse_pair``, with the numerics mode passed as an argument."""

from .logsumexp import MODES, check_mode, expf, ln_exp_1p, lse_pair

__all__ = ["MODES", "check_mode", "expf", "ln_exp_1p", "lse_pair"]
