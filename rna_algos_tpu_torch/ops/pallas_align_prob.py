"""Kernel K14: the Durbin pair-HMM in scaled probability space
(``rna_algos_tpu.ops.pallas_align_prob``), the exact and fast tiers.

The log-space fill (``pallas_align``, K15) pays a log-add per state
combine; here every log-add is a sum and every lse a plain sum.  A cell
(i, j) covers i + j HMM steps, so states store S(i, j) * exp(-(i + j) *
ln_sigma) for a per-pair ``ln_sigma``, and the powers fold into the
emission tables:

* match emits after a 2-step move:       MS' = exp(MS - 2 * ln_sigma),
* insert / delete emit after 1 step:     INS' = exp(INS - ln_sigma),
* transitions carry no steps:            t' = exp(t).

The scaled partition function is the corner sum z' and the posterior is
``p(i, j) = FM'(i, j) * ssum'(i, j) / z'`` (durbin_algo.rs:201-242).  Pairs
whose z' leaves [GLOB_LO, GLOB_HI] re-run at a walked ln_sigma
(``pallas_fold_prob._retrying`` with ``jump=False``, as the JAX package
calls its loop here).  ``pairhmm_prob`` launches ``csrc/pairhmm.cu`` for
CUDA tensors and runs the plain wavefront for CPU tensors.

The TPU padded the batch to 128-pair lane blocks; the port runs the pairs
it is given (retries are per pair, so the dummy pairs never changed a real
pair's result).
"""

import torch

from . import _build
from . import pallas_align as PA
from . import pallas_fold_prob as PP

prob_launches = _build.LaunchCounter("pairhmm_prob")


def pairhmm_prob_plain(x1, x2, n1, n2, ms, ins, scal, backward):
    return PA._pairhmm_plain(x1, x2, n1, n2, ms, ins, scal, backward,
                             PA.ProbSemiring)


def pairhmm_prob(x1, x2, n1, n2, ms, ins, scal, backward):
    """K14, one pass over P pairs in scaled probability space: the
    contract of ``pallas_align.pairhmm_log`` with exp'd per-pair tables
    (``ms`` = exp(MS - 2 ln_sigma), ``ins`` = exp(INS - ln_sigma)), exp'd
    scalars, and 0 outside [0, n1-2] x [0, n2-2]."""
    return PA._dispatch("pairhmm_prob", prob_launches, x1, x2, n1, n2, ms,
                        ins, scal, backward, PA.ProbSemiring)


def _durbin_prob_body(s1, n1, s2, n2, at, lsp, N):
    """One forward + backward run at per-pair scale ``lsp`` (P,):
    (match probabilities (P, N, N), scaled partition function (P,))."""
    ms = torch.exp(at["match_scores"][None] - 2.0 * lsp[:, None, None])
    ins = torch.exp(at["insert_scores"][None] - lsp[:, None])
    zero = torch.zeros((), device=s1.device)
    scal_f = torch.exp(PA._scalars(at, at["init_match_score"],
                                   at["init_insert_score"]))
    scal_b = torch.exp(PA._scalars(at, zero, zero))   # unit init backward
    FM, corn = pairhmm_prob(s1, s2, n1, n2, ms, ins, scal_f, False)
    ssum, _ = pairhmm_prob(s1, s2, n1, n2, ms, ins, scal_b, True)
    z = corn[:, 0] + corn[:, 1] + corn[:, 2]
    # a subnormal z is out of band, never a divisor (XLA flushes it to 0)
    pos = z >= PP.FLT_MIN
    inv_z = torch.where(pos, 1.0 / torch.where(pos, z, 1.0), 0.0)
    p = FM * ssum * inv_z[:, None, None]
    return torch.where(PA.inner_mask(n1, n2, N), p, 0.0), z


def ln_sigma_seed(at):
    """The match-dominated per-step log growth 0.5 * (mean(MS[:4, :4]) +
    m2m), the mean summed in row-major order as XLA sums it."""
    flat = at["match_scores"][:4, :4].reshape(-1)
    total = flat[0]
    for v in flat[1:]:
        total = total + v
    return 0.5 * (total / 16.0 + at["match2match_score"])


def durbin_match_probs_batch_pallas_prob(seqs1, ns1, seqs2, ns2, at, N):
    """Scaled-probability pair-HMM with rescale retries: (P, N) int32
    sentinel-wrapped pairs, (P,) int32 lengths, ``at`` from
    ``weights.align_tables`` -> (P, N, N) float32 match probabilities."""

    def run(ls):
        return _durbin_prob_body(seqs1, ns1, seqs2, ns2, at, ls, N)

    probs, _ls = PP._retrying(run, ns1, ls0=ln_sigma_seed(at), jump=False)
    return probs
