"""McCaskill base-pair probabilities (``rna_algos_tpu.models.mccaskill``).

The kernel tiers are the branches of ``mccaskill_bpp_batch_pallas``, both
models.  The probability-space tiers ("exact" and "fast" numerics): the
stacked tier for buckets N <= 256 (kernels K1/K2, K4/K5) and the long tier
for N = 512, 1024 (both models) and 2048 (CONTRA) (kernels K8/K9,
K12/K13), each with rescale retries, then ``_prob_finish``.  The parity
tier: the log-space kernels K16/K17 (CONTRA) and K18/K19 (Turner) at
power-of-two N <= 256, then ``_log_finish``.  Every other bucket takes the
generic-N scan of the JAX package (``mccaskill_bpp_batch``): the span
kernels K20/K21 (``ops/fold_scan.py``) in cubic log space under "exact"
and "parity", with ``logaddexp`` under "fast".  The dispatch follows the
tensors' device: CUDA tensors launch the kernels, CPU tensors run their
plain versions.
"""

import torch

from ..constants import NEG_INF
from ..numerics import check_mode, expf
from ..ops import fold_scan as FS
from ..ops import pallas_fold as PF
from ..ops import pallas_fold_long as PL
from ..ops import pallas_fold_prob8 as P8
from ..ops import scores as S
from ..ops.pallas_skew import skew_pq_batch


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
    tier's finish: ``_scan_finish`` in the reference's cubic."""
    return _scan_finish(bppo.transpose(1, 2), ns, N, "parity")


def _precompute(seqs, ns, tbl, N, contra):
    fn = S.precompute_contra if contra else S.precompute_turner
    return fn(seqs, ns, N, tbl)


def _scan_finish(bppo, ns, N, mode):
    """[b, i, d] log table of the scan -> (square bpp, presence):
    bpp = expf(bppo) in the mode's numerics, presence = isfinite(bppo) (a
    pair whose BPP the cubic flushes to 0 is present), both through one K3
    ``inv=True`` permutation, 0 past each length."""
    sq, pres = skew_pq_batch(
        [expf(bppo, mode).contiguous(),
         torch.isfinite(bppo).to(torch.float32).contiguous()], inv=True)
    j = torch.arange(N, device=bppo.device)[None, None, :]
    live = j < ns.to(bppo.device).view(-1, 1, 1)
    zero = torch.zeros((), device=bppo.device)
    return torch.where(live, sq, zero), torch.where(live, pres, zero) > 0.5


def _scan_body(seqs, ns, tbl, N, contra, allows_short_hairpins, mode):
    """``_mccaskill_bpp_body`` for a batch: the score tables, the inside
    (K20) and outside (K21) scans, the finish.  Returns (bpp, presence,
    tables, inside state)."""
    check_mode(mode)
    pre = _precompute(seqs, ns, tbl, N, contra)
    inside = FS.scan_inside(seqs, ns, tbl, pre, contra,
                            allows_short_hairpins, mode)
    out = FS.scan_outside(seqs, ns, tbl, pre, inside, contra,
                          allows_short_hairpins, mode)
    bpp, presence = _scan_finish(out["bppo"], ns, N, mode)
    return bpp, presence, pre, inside


def _score_memos(pre):
    return {"hairpin": pre["H"], "multibranch_close": pre["MBC"],
            "accessible": pre["ACC"]}


def mccaskill_bpp_batch(seqs, ns, tbl, N, contra=False,
                        allows_short_hairpins=False, return_memos=False,
                        numerics="exact"):
    """The generic-N scan at any bucket N: (bpp, presence), each (B, N, N).
    With ``return_memos=True``, (bpp, memos): the batched FoldScores memos
    {"hairpin", "multibranch_close", "accessible"} in left layout
    [b, i, d] = score(i, i + d), plus "presence"."""
    bpp, presence, pre, _ = _scan_body(seqs, ns, tbl, N, contra,
                                       allows_short_hairpins, numerics)
    if return_memos:
        return bpp, dict(_score_memos(pre), presence=presence)
    return bpp, presence


def mccaskill_bpp(seq, n, tbl, N, contra=False, allows_short_hairpins=False,
                  numerics="exact"):
    """Base-pair probabilities of one padded sequence ``seq`` (N,) of true
    length ``n`` through the generic-N scan: (bpp (N, N), memos), memos
    the FoldScores grids {"hairpin", "multibranch_close", "accessible"}
    and the inside tables "close" and "external", each [i, d] in left
    layout, plus "presence".  The inside tables hold their fills (-inf, 0)
    past the end (i + d >= n), where no pair reaches."""
    seqs = torch.as_tensor(seq).reshape(1, N).to(torch.int64)
    ns = torch.as_tensor([int(n)], dtype=torch.int32, device=seqs.device)
    bpp, presence, pre, inside = _scan_body(
        seqs, ns, tbl, N, contra, allows_short_hairpins, numerics)
    memos = dict(_score_memos(pre), close=inside["close"],
                 external=inside["ext"], presence=presence)
    return bpp[0], {k: v[0] for k, v in memos.items()}


def mccaskill_twoloop_memo(seq, n, tbl, N, contra=False):
    """The per-sequence 2-loop score memo: (N, N, 31, 31) TL[d, i, a, b] =
    2-loop score with outer pair (i, i + d) and inner pair (i + 1 + a,
    i + d - 1 - b), NEG_INF outside the window (a + b <= min(30, d - 3),
    i + d < n).  On demand only, not in the batch memos: O(n^2 L^2)
    floats."""
    seqs = torch.as_tensor(seq).reshape(1, N).to(torch.int64)
    ns = torch.as_tensor([int(n)], dtype=torch.int32, device=seqs.device)
    pre = _precompute(seqs, ns, tbl, N, contra)
    twoloop = S.twoloop_inside_contra if contra else S.twoloop_inside_turner
    a, b = S._ab(seqs.device)
    i = torch.arange(N, device=seqs.device)[:, None, None]
    neg = torch.full((), NEG_INF, device=seqs.device)
    out = []
    for d in range(N):
        valid = (a + b <= min(30, d - 3)) & (i + d < int(n))
        out.append(torch.where(valid, twoloop(seqs, tbl, pre, d, N)[0], neg))
    return torch.stack(out)


def mccaskill_bpp_batch_auto(seqs, ns, tbl, N, contra=False,
                             allows_short_hairpins=False, numerics="exact",
                             return_memos=False):
    """(bpp, presence), each (B, N, N), for ``seqs`` (B, N) int64 and ``ns``
    (B,) int32, as the JAX package's ``mccaskill_bpp_batch_auto``.
    ``tbl`` is ``weights.contra_tables`` (``contra=True``) or
    ``weights.turner_tables``.  ``numerics`` "exact" or "fast": N <= 256
    runs the stacked probability tier, N = 512, 1024 (and 2048 for CONTRA)
    the long tier.  "parity": the log-space kernels at power-of-two
    N <= 256.  Every other bucket runs the generic-N scan
    (``mccaskill_bpp_batch``).  ``return_memos=True`` returns (bpp, memos)
    with the batched FoldScores memos on every path.

    Runs where the tensors live: on a CUDA device through the kernels, on
    the CPU through their plain versions.  Nothing moves between devices."""
    if not pallas_available(contra, N, numerics):
        return mccaskill_bpp_batch(
            seqs, ns, tbl, N, contra=contra,
            allows_short_hairpins=allows_short_hairpins,
            return_memos=return_memos, numerics=numerics)
    if numerics == "parity":
        if contra:
            bppo = PF.mccaskill_contra_pallas(
                seqs, ns, tbl, N, allows_short_hairpins=allows_short_hairpins
            )[0]
        else:
            bppo = PF.mccaskill_turner_pallas(seqs, ns, tbl, N)[0]
        bpp, presence = _log_finish(bppo, ns, N)
    else:
        if contra:
            fold = (P8.mccaskill_contra_prob if N <= P8.MAX_N
                    else PL.mccaskill_contra_pallas_prob)
            bppo, _ls = fold(seqs, ns, tbl, N=N,
                             allows_short_hairpins=allows_short_hairpins)
        else:
            fold = (P8.mccaskill_turner_prob if N <= P8.MAX_N
                    else PL.mccaskill_turner_pallas_prob)
            bppo, _ls = fold(seqs, ns, tbl, N=N)
        bpp, presence = _prob_finish(bppo, ns, N)
    if return_memos:
        pre = _precompute(seqs, ns, tbl, N, contra)
        return bpp, dict(_score_memos(pre), presence=presence)
    return bpp, presence
