"""McCaskill base-pair probabilities (``rna_algos_tpu.models.mccaskill``).

The port covers the stacked probability-space branch of
``mccaskill_bpp_batch_pallas`` for buckets N <= 256, both models: the
scaled inside and outside kernels with rescale retries, then
``_prob_finish``.  The dispatch follows the tensors' device: CUDA tensors
launch the kernels, CPU tensors run their plain versions.  The chunked
long-sequence tier and the parity tier's log-space kernels are not ported
yet (ROADMAP).
"""

import torch

from ..ops import pallas_fold_prob8 as P8
from ..ops.pallas_skew import skew_pq_batch


def _prob_finish(bppo, ns, N):
    """[d, i] probability table -> (square bpp, presence) per sequence; the
    [i, d] -> square permutation is kernel K3 with ``inv=True``."""
    bppo_left = bppo.transpose(1, 2).contiguous()
    sq = skew_pq_batch([bppo_left], inv=True)[0]
    j = torch.arange(N, device=bppo.device)[None, None, :]
    bpp = torch.where(j < ns.to(bppo.device).view(-1, 1, 1), sq,
                      torch.zeros((), device=bppo.device))
    return bpp, bpp > 0.0


def mccaskill_bpp_batch_auto(seqs, ns, tbl, N, contra=False,
                             allows_short_hairpins=False):
    """(bpp, presence), each (B, N, N), for ``seqs`` (B, N) int64 and ``ns``
    (B,) int32: the stacked probability-space branch of
    ``mccaskill_bpp_batch_pallas`` behind the JAX package's
    ``mccaskill_bpp_batch_auto``.  ``tbl`` is ``weights.contra_tables``
    (``contra=True``) or ``weights.turner_tables``.

    Runs where the tensors live: on a CUDA device through the kernels, on
    the CPU through their plain versions.  Nothing moves between devices."""
    if contra:
        bppo, _ls = P8.mccaskill_contra_prob(
            seqs, ns, tbl, N=N, allows_short_hairpins=allows_short_hairpins
        )
    else:
        bppo, _ls = P8.mccaskill_turner_prob(seqs, ns, tbl, N=N)
    return _prob_finish(bppo, ns, N)
