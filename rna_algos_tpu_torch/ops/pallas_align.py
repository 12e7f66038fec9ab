"""Kernel K15: the Durbin pair-HMM in log space (``rna_algos_tpu.ops.pallas_align``).

The 3-state forward/backward fill of `reference/src/durbin_algo.rs:79-199`
with the reference's piecewise-cubic ``lse_pair``, the parity tier, and
its fast instance with the hardware log-add (``torch.logaddexp``), which
the JAX kernel computes when traced under "fast".
``pairhmm_log`` launches ``csrc/pairhmm.cu`` for CUDA tensors and runs the
plain version for CPU tensors.  The plain wavefront here (``_pairhmm_plain``)
serves both K15 and K14 (``pallas_align_prob``): the two differ only in the
semiring, as the kernel's two entry points do.

The TPU ran 128 pairs on the lanes, the anti-diagonals as a sequential
grid, and unskewed a diagonal-layout output with XLA (``_to_blocks``,
``_unskew``); here a pass returns (P, N, N) planes directly, the backward
pass's posterior context already in forward coordinates.
"""

import torch

from ..constants import NEG_INF, PSEUDO_BASE
from ..numerics import check_mode, expf, lse_pair

from . import _build

NB = 5           # base slots, the PSEUDO row included
MAX_N = 256      # RNA_PAIRHMM_MAX_N in csrc/pairhmm.cu


class ProbSemiring:
    """K14: scaled probabilities, in the JAX kernel's association."""
    zero, one = 0.0, 1.0

    @staticmethod
    def match(m2, tmm, i2, d2, m2i):
        return m2 * tmm + (i2 + d2) * m2i

    @staticmethod
    def pair(a, ta, b, tb):
        return a * ta + b * tb

    @staticmethod
    def emit(t, e):
        return t * e

    @staticmethod
    def ss(fm, tend, fi, fd, m2i):
        return fm * tend + (fi + fd) * m2i


class LogSemiring:
    """K15: log space with the cubic ``lse_pair``."""
    zero, one = NEG_INF, 0.0
    mode = "parity"

    @classmethod
    def match(cls, m2, tmm, i2, d2, m2i):
        return _lse3(m2 + tmm, i2 + m2i, d2 + m2i, cls.mode)

    @classmethod
    def pair(cls, a, ta, b, tb):
        return lse_pair(a + ta, b + tb, cls.mode)

    @staticmethod
    def emit(t, e):
        return t + e

    @classmethod
    def ss(cls, fm, tend, fi, fd, m2i):
        return _lse3(fm + tend, fi + m2i, fd + m2i, cls.mode)


class FastLogSemiring(LogSemiring):
    """K15's fast instance: log space with the hardware log-add
    (``torch.logaddexp``)."""
    mode = "fast"


def _lse3(a, b, c, mode="parity"):
    return lse_pair(lse_pair(a, b, mode), c, mode)


def _pass_seqs(x, n, backward):
    """(P, N) bases in the pass's coordinates: reversed by index within
    each length on the backward pass, PSEUDO_BASE past it."""
    if not backward:
        return x.long()
    N = x.shape[1]
    k = torch.arange(N, device=x.device)
    idx = (n.long()[:, None] - 1 - k).clamp(0, N - 1)
    return torch.where(k < n[:, None], x.long().gather(1, idx), PSEUDO_BASE)


def _pairhmm_plain(x1, x2, n1, n2, ms, ins, scal, backward, sr):
    """The wavefront of one pass for the whole batch, one anti-diagonal per
    step: (out (P, N, N), corner (P, 3)), the kernel's contract."""
    P, N = x1.shape
    dev = x1.device
    m2m, m2i, ext, init_m, init_i = scal.unbind()
    zero = torch.tensor(sr.zero, device=dev)
    one = torch.tensor(sr.one, device=dev)
    s1 = _pass_seqs(x1, n1, backward)
    s2 = _pass_seqs(x2, n2, backward)
    ii = torch.arange(N, device=dev)
    n1l, n2l = n1.long()[:, None], n2.long()[:, None]
    row_ok = ii[None] < n1l - 1
    msrow = ms.reshape(P, NB * NB)
    ins1 = ins.gather(1, s1)
    # flat output with one spare column that unwritten cells point at
    flat = torch.full((P, N * N + 1), sr.zero, device=dev)
    corner = torch.full((P, 3), sr.zero, device=dev)
    M1, I1, D1, M2, I2, D2 = (torch.full((P, N + 1), sr.zero, device=dev)
                              for _ in range(6))
    for d in range(2 * N - 3):
        j = d - ii
        valid = row_ok & (j[None] >= 0) & (j[None] < n2l - 1)
        b2 = s2.gather(1, j.clamp(0, N - 1).expand(P, N))
        msv = msrow.gather(1, s1 * NB + b2)
        tmm = torch.where((ii == 1) & (j == 1), init_m, m2m)
        fm = torch.where(valid & (ii >= 1) & (j >= 1),
                         sr.emit(sr.match(M2[:, :N], tmm, I2[:, :N], D2[:, :N],
                                          m2i), msv), zero)
        fm = torch.where(valid & (ii == 0) & (j == 0), one, fm)
        tmi = torch.where((ii == 1) & (j == 0), init_i, m2i)
        fi = torch.where(valid & (ii >= 1),
                         sr.emit(sr.pair(M1[:, :N], tmi, I1[:, :N], ext),
                                 ins1), zero)
        td = torch.where((ii == 0) & (j == 1), init_i, m2i)
        fd = torch.where(valid & (j >= 1),
                         sr.emit(sr.pair(M1[:, 1:], td, D1[:, 1:], ext),
                                 ins.gather(1, b2)), zero)
        if backward:
            tend = torch.where((ii == 0) & (j == 0), one, m2m)
            v = sr.ss(fm, tend, fi, fd, m2i)
            cell = (n1l - 2 - ii) * N + (n2l - 2 - j)
        else:
            v = fm
            cell = (ii * N + j).expand(P, N)
        flat.scatter_(1, torch.where(valid, cell, N * N), v)
        hit = valid & (ii == n1l - 2) & (j == n2l - 2)
        for k, s in enumerate((fm, fi, fd)):
            corner[:, k] = torch.maximum(
                corner[:, k], torch.where(hit, s, zero).amax(dim=1))
        M2, I2, D2 = M1, I1, D1
        M1, I1, D1 = (torch.cat([M2[:, :1], s], dim=1) for s in (fm, fi, fd))
    return flat[:, :N * N].reshape(P, N, N), corner


def _plane(P, N1, N2, device):
    """The (P, N1, N2) output plane of a kernel pass (K14, K15, K22):
    uninitialised, the kernel writes every cell once."""
    return torch.empty((P, N1, N2), device=device)


def _pairhmm_cuda(entry, x1, x2, n1, n2, ms, ins, scal, backward, sr):
    """Check the inputs of a pair-HMM kernel (K14 or K15) and launch it."""
    dev = x1.device
    P, N = x1.shape
    if N > MAX_N:
        raise ValueError(f"{entry}: N = {N}, at most {MAX_N}")
    ins_ = dict(x1=x1, x2=x2, n1=n1, n2=n2, ms=ms, ins=ins, scal=scal)
    shapes = dict(x1=(P, N), x2=(P, N), n1=(P,), n2=(P,), ms=(P, NB, NB),
                  ins=(P, NB), scal=(5,))
    _build.check_cuda(entry, ins_, shapes, dev, ints=("x1", "x2", "n1", "n2"))
    out = _plane(P, N, N, dev)
    corner = torch.full((P, 3), sr.zero, device=dev)
    args = [x1, x2, n1, n2, ms, ins, scal, out, corner]
    _build.library().call(
        entry, *[_build.ptr(t) for t in args], P, N, int(backward),
        _build.stream_ptr(dev),
    )
    return out, corner


def _dispatch(name, counter, x1, x2, n1, n2, ms, ins, scal, backward, sr):
    dev = x1.device
    if dev.type == "cpu":
        return _pairhmm_plain(x1, x2, n1, n2, ms, ins, scal, backward, sr)
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    out = _pairhmm_cuda(f"rna_{name}", x1, x2, n1, n2, ms, ins, scal,
                        backward, sr)
    counter.add()
    return out


log_launches = _build.LaunchCounter("pairhmm_log")
log_fast_launches = _build.LaunchCounter("pairhmm_log_fast")


def pairhmm_log_plain(x1, x2, n1, n2, ms, ins, scal, backward, fast=False):
    return _pairhmm_plain(x1, x2, n1, n2, ms, ins, scal, backward,
                          FastLogSemiring if fast else LogSemiring)


def pairhmm_log(x1, x2, n1, n2, ms, ins, scal, backward, fast=False):
    """K15, one pass over P pairs in log space: the cubic log-add, or with
    ``fast`` the instance with the hardware one (``torch.logaddexp``).

    x1, x2: (P, N) int32 sentinel-wrapped bases (forward coordinates);
    n1, n2: (P,) int32 lengths; ms (P, 5, 5) and ins (P, 5) float32 score
    tables; scal (5,) [m2m, m2i, ext, init_m, init_i].  Returns (out
    (P, N, N), corner (P, 3)): forward, the match states M[i, j] and the
    corner M/I/D sums at (n1-2, n2-2); backward (the pair reversed, unit
    init scores), the posterior context ssum[i, j] in forward coordinates.
    -inf outside [0, n1-2] x [0, n2-2]."""
    if fast:
        return _dispatch("pairhmm_log_fast", log_fast_launches, x1, x2, n1,
                         n2, ms, ins, scal, backward, FastLogSemiring)
    return _dispatch("pairhmm_log", log_launches, x1, x2, n1, n2, ms, ins,
                     scal, backward, LogSemiring)


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def inner_mask(n1, n2, N, N2=None):
    """(P, N, N2) (N2 = N by default) True on [1, n1-2] x [1, n2-2], the
    posterior's support (durbin_algo.rs:201-242)."""
    ii = torch.arange(N, device=n1.device)
    jj = torch.arange(N if N2 is None else N2, device=n1.device)
    n1l, n2l = n1.long()[:, None, None], n2.long()[:, None, None]
    return ((ii[None, :, None] >= 1) & (ii[None, :, None] <= n1l - 2)
            & (jj[None, None, :] >= 1) & (jj[None, None, :] <= n2l - 2))


def _scalars(at, init_m, init_i):
    return torch.stack([
        at["match2match_score"], at["match2insert_score"],
        at["insert_extend_score"], init_m, init_i,
    ]).to(torch.float32)


def log_posterior(pass_fn, seqs1, ns1, seqs2, ns2, at, numerics):
    """Log-space forward and backward passes through ``pass_fn`` (K15, or
    the row scan K22: the kernels' contract, (x1, x2, n1, n2, ms, ins,
    scal, backward) -> (plane, corner)) and the posterior finish
    p = expf(FM + ssum - z), z the lse3 of the forward corner, zero
    outside [1, n1-2] x [1, n2-2]."""
    P, N1 = seqs1.shape
    ms = at["match_scores"].expand(P, NB, NB).contiguous()
    ins = at["insert_scores"].expand(P, NB).contiguous()
    zero = torch.zeros((), device=seqs1.device)
    FM, corn = pass_fn(seqs1, seqs2, ns1, ns2, ms, ins, _scalars(
        at, at["init_match_score"], at["init_insert_score"]), False)
    ssum, _ = pass_fn(seqs1, seqs2, ns1, ns2, ms, ins,
                      _scalars(at, zero, zero), True)
    z = _lse3(corn[:, 0], corn[:, 1], corn[:, 2], numerics)
    p = expf(FM + ssum - z[:, None, None], numerics)
    return torch.where(inner_mask(ns1, ns2, N1, seqs2.shape[1]), p, 0.0)


def durbin_match_probs_batch_pallas(seqs1, ns1, seqs2, ns2, at, N,
                                    numerics="parity"):
    """Posterior match probabilities through K15: (P, N) int32
    sentinel-wrapped pairs, (P,) int32 lengths, ``at`` from
    ``weights.align_tables`` -> (P, N, N) float32, zero outside
    [1, n1-2] x [1, n2-2].  ``numerics`` "exact" or "parity" (the same
    cubics) or "fast" (K15's instance with the hardware log-add, and
    ``torch.exp`` in the finish)."""
    fast = check_mode(numerics) == "fast"
    return log_posterior(
        lambda *args: pairhmm_log(*args, fast=fast),
        seqs1, ns1, seqs2, ns2, at, numerics)


def pallas_available(N1, N2):
    """The pair-HMM kernels apply: a square power-of-two bucket <= 256
    (on any device; the JAX package also asks for a TPU)."""
    return N1 == N2 and N1 <= MAX_N and N1 >= 1 and (N1 & (N1 - 1)) == 0
