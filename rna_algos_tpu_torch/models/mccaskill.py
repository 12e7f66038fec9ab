"""McCaskill base-pair probabilities (``rna_algos_tpu.models.mccaskill``).

The port covers the branches of ``mccaskill_bpp_batch_pallas``, both
models.  The probability-space tiers ("exact" and "fast" numerics): the
stacked tier for buckets N <= 256 (kernels K1/K2, K4/K5) and the long tier
for N = 512, 1024 (both models) and 2048 (CONTRA) (kernels K8/K9,
K12/K13), each with rescale retries, then ``_prob_finish``.  The parity
tier: the log-space kernels K16/K17 (CONTRA) and K18/K19 (Turner) at
power-of-two N <= 256, then ``_log_finish``.  The dispatch follows the
tensors' device: CUDA tensors launch the kernels, CPU tensors run their
plain versions.  The XLA scan past those tiers, which is also where the
JAX package runs parity past 256, is not ported yet (ROADMAP A10).
"""

import torch

from ..numerics import check_mode, expf
from ..ops import pallas_fold as PF
from ..ops import pallas_fold_long as PL
from ..ops import pallas_fold_prob8 as P8
from ..ops.pallas_skew import skew_pq_batch

GENERIC_N_ITEM = (
    "needs the generic-N XLA-scan path, not ported yet (ROADMAP A10)"
)


def pallas_available(contra, N, numerics="exact"):
    """Whether the port has kernels for bucket N (the JAX package's
    ``pallas_available`` tiers): power-of-two N <= 256, and for the
    probability tiers N = 512 and 1024, and N = 2048 for CONTRA only."""
    if N > P8.MAX_N:
        return check_mode(numerics) != "parity" and N in PL.long_tiers(contra)
    return N >= 32 and (N & (N - 1)) == 0


def _prob_finish(bppo, ns, N):
    """[d, i] probability table -> (square bpp, presence) per sequence; the
    [i, d] -> square permutation is kernel K3 with ``inv=True``."""
    bppo_left = bppo.transpose(1, 2).contiguous()
    sq = skew_pq_batch([bppo_left], inv=True)[0]
    j = torch.arange(N, device=bppo.device)[None, None, :]
    bpp = torch.where(j < ns.to(bppo.device).view(-1, 1, 1), sq,
                      torch.zeros((), device=bppo.device))
    return bpp, bpp > 0.0


def _log_finish(bppo, ns, N):
    """[d, i] log table -> (square bpp, presence) per sequence, the parity
    tier's finish: bpp = expf(bppo) with the reference's cubic, presence =
    isfinite(bppo) (a pair whose BPP the cubic flushes to 0 is present).
    Both go through one K3 ``inv=True`` permutation."""
    left = bppo.transpose(1, 2)
    sq, pres = skew_pq_batch(
        [expf(left, "parity").contiguous(),
         torch.isfinite(left).to(torch.float32).contiguous()], inv=True)
    j = torch.arange(N, device=bppo.device)[None, None, :]
    live = j < ns.to(bppo.device).view(-1, 1, 1)
    zero = torch.zeros((), device=bppo.device)
    return torch.where(live, sq, zero), torch.where(live, pres, zero) > 0.5


def mccaskill_bpp_batch_auto(seqs, ns, tbl, N, contra=False,
                             allows_short_hairpins=False, numerics="exact"):
    """(bpp, presence), each (B, N, N), for ``seqs`` (B, N) int64 and ``ns``
    (B,) int32: the branches of ``mccaskill_bpp_batch_pallas`` behind the
    JAX package's ``mccaskill_bpp_batch_auto``.  ``tbl`` is
    ``weights.contra_tables`` (``contra=True``) or ``weights.turner_tables``.
    ``numerics`` "exact" or "fast": N <= 256 runs the stacked probability
    tier, N = 512, 1024 (and 2048 for CONTRA) the long tier.  "parity":
    the log-space kernels at power-of-two N <= 256.  Any other N raises
    NotImplementedError.

    Runs where the tensors live: on a CUDA device through the kernels, on
    the CPU through their plain versions.  Nothing moves between devices."""
    if not pallas_available(contra, N, numerics):
        model = "CONTRA" if contra else "Turner"
        raise NotImplementedError(f"{model} bucket N = {N} under "
                                  f"{numerics} numerics {GENERIC_N_ITEM}")
    if numerics == "parity":
        if contra:
            bppo = PF.mccaskill_contra_pallas(
                seqs, ns, tbl, N, allows_short_hairpins=allows_short_hairpins
            )[0]
        else:
            bppo = PF.mccaskill_turner_pallas(seqs, ns, tbl, N)[0]
        return _log_finish(bppo, ns, N)
    if contra:
        fold = (P8.mccaskill_contra_prob if N <= P8.MAX_N
                else PL.mccaskill_contra_pallas_prob)
        bppo, _ls = fold(seqs, ns, tbl, N=N,
                         allows_short_hairpins=allows_short_hairpins)
    else:
        fold = (P8.mccaskill_turner_prob if N <= P8.MAX_N
                else PL.mccaskill_turner_pallas_prob)
        bppo, _ls = fold(seqs, ns, tbl, N=N)
    return _prob_finish(bppo, ns, N)
