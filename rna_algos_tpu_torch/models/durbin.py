"""Durbin 3-state pair-HMM posterior match probabilities
(``rna_algos_tpu.models.durbin``): the dispatch to the wavefront kernels.

Sequences carry PSEUDO_BASE sentinels at both ends, as the reference CLI
does (bin/durbin_algo.rs:49-50); the score tables carry a zero PSEUDO row,
so the sentinels and the padding are score-neutral.

The JAX package's row scan (``_pairhmm_rows``), which serves non-square
buckets and buckets past 256, is not ported: those shapes raise.
"""

from ..numerics import check_mode
from ..ops import pallas_align as PA
from ..ops import pallas_align_prob as PAP

GENERIC_ITEM = (
    "needs the pair-HMM row scan (non-square buckets, buckets past 256), "
    "not ported yet (ROADMAP A10)"
)


def durbin_match_probs_batch_auto(seqs1, ns1, seqs2, ns2, at, N1, N2,
                                  numerics="exact"):
    """(P, N1), (P,), (P, N2), (P,) int32 tensors -> (P, N1, N2) match
    probabilities: K14 (scaled probabilities) for ``numerics`` "exact" or
    "fast", K15 (log space, cubic log-add) for "parity"."""
    check_mode(numerics)
    if not PA.pallas_available(N1, N2):
        raise NotImplementedError(
            f"pair bucket ({N1}, {N2}) {GENERIC_ITEM}")
    if numerics in ("exact", "fast"):
        return PAP.durbin_match_probs_batch_pallas_prob(
            seqs1, ns1, seqs2, ns2, at, N=N1)
    return PA.durbin_match_probs_batch_pallas(
        seqs1, ns1, seqs2, ns2, at, N=N1, numerics=numerics)
