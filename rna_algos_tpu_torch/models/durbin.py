"""Durbin 3-state pair-HMM posterior match probabilities
(``rna_algos_tpu.models.durbin``): the row scan and the dispatch to the
wavefront kernels.

Sequences carry PSEUDO_BASE sentinels at both ends, as the reference CLI
does (bin/durbin_algo.rs:49-50); the score tables carry a zero PSEUDO row,
so the sentinels and the padding are score-neutral.

Square power-of-two buckets up to 256 run the wavefronts K14 (scaled
probabilities; "exact" and "fast") and K15 (log space; "parity"); every
other bucket, rectangular or past 256, runs the row scan K22
(``ops.pairhmm_rows``), as the JAX package runs its XLA row scan there.
"""

import torch

from ..numerics import check_mode
from ..ops import pairhmm_rows as PR
from ..ops import pallas_align as PA
from ..ops import pallas_align_prob as PAP


def durbin_match_probs_batch(seqs1, ns1, seqs2, ns2, at, N1, N2,
                             numerics="exact"):
    """The row scan (kernel K22) over a batch of pairs: (P, N1), (P,),
    (P, N2), (P,) int32 tensors, ``at`` from ``weights.align_tables`` ->
    (P, N1, N2) float32 match probabilities, zero outside
    [1, n1-2] x [1, n2-2]: the forward pass's FM and corner, the backward
    pass's context ssum, then the JAX body's finish."""
    check_mode(numerics)
    return PA.log_posterior(
        lambda *args: PR.pairhmm_rows(*args, numerics),
        seqs1, ns1, seqs2, ns2, at, numerics)


def durbin_match_probs(seq1, n1, seq2, n2, at, N1, N2, numerics="exact"):
    """One pair through the row scan: (N1,), (N2,) int32 tensors and their
    lengths -> (N1, N2) match probabilities."""
    dev = seq1.device

    def one(n):
        return torch.as_tensor(n, dtype=torch.int32, device=dev).reshape(1)

    return durbin_match_probs_batch(seq1[None], one(n1), seq2[None], one(n2),
                                    at, N1, N2, numerics)[0]


def durbin_match_probs_batch_auto(seqs1, ns1, seqs2, ns2, at, N1, N2,
                                  numerics="exact"):
    """(P, N1), (P,), (P, N2), (P,) int32 tensors -> (P, N1, N2) match
    probabilities: in a square power-of-two bucket up to 256, K14 (scaled
    probabilities) for ``numerics`` "exact" or "fast" and K15 (log space,
    cubic log-add) for "parity"; in any other bucket the row scan K22."""
    check_mode(numerics)
    if not PA.pallas_available(N1, N2):
        return durbin_match_probs_batch(seqs1, ns1, seqs2, ns2, at, N1, N2,
                                        numerics)
    if numerics in ("exact", "fast"):
        return PAP.durbin_match_probs_batch_pallas_prob(
            seqs1, ns1, seqs2, ns2, at, N=N1)
    return PA.durbin_match_probs_batch_pallas(
        seqs1, ns1, seqs2, ns2, at, N=N1, numerics=numerics)
