"""Kernel K22: the Durbin pair-HMM row scan (``rna_algos_tpu.models.durbin``'s
``_pairhmm_rows``), one pass over a batch of pairs in any (N1, N2) bucket.

The wavefronts K14/K15 (``pallas_align_prob``, ``pallas_align``) take the
square power-of-two buckets up to 256; every other bucket (rectangular ones,
and those past 256) runs this row scan, as the JAX package runs its XLA row
scan there.  It is a different function from K15's wavefront, not a
re-layout of it: the delete state D of a row is the prefix scan
``x[j] = lse(b[j], c[j] + x[j-1])`` with ``b = a + ins2`` and
``c = ext + ins2``, which JAX sums through ``lax.associative_scan``.  The
cubic log-add is neither associative nor shift-invariant, so the bits
depend on the scan's combine tree; the plain version here replays that tree
(``_linrec_lse``) and the kernel (``csrc/pairhmm_rows.cu``) sums the same
tree, so the two agree bit for bit under "exact" and "parity" (the same
cubics), and both equal the JAX row scan run eagerly.

``pairhmm_rows`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors.  The kernel takes any N1 and N2: a pair's columns
go to a cluster of blocks (``rows_plan``), in registers up to 8,192
columns and past that in a scratch the wrapper allocates.  A pass returns two planes' worth of what the
JAX body keeps six of: forward, the match states FM and the corner sums;
backward (the pair reversed, zero init scores), the posterior context
``ssum`` already in forward coordinates.
"""

import ctypes

import torch

from ..constants import NEG_INF
from ..numerics import check_mode, lse_pair

from . import _build
from . import pallas_align as PA
from .pallas_align import NB, _lse3, _pass_seqs

# Scratch rows of W floats a pair when the runs live in global memory
# (RNA_ROWS_SCRATCH).
SCRATCH_ROWS = 7


def _shift_right(v):
    """v[..., j - 1] at j, -inf at j = 0 (the JAX ``_shift_right``)."""
    fill = torch.full(v.shape[:-1] + (1,), NEG_INF, device=v.device)
    return torch.cat([fill, v[..., :-1]], dim=-1)


def _interleave(even, odd):
    n = even.shape[-1] + odd.shape[-1]
    out = torch.empty(even.shape[:-1] + (n,), device=even.device)
    out[..., 0::2] = even
    out[..., 1::2] = odd
    return out


def _linrec_lse(b, c, mode):
    """x[j] = lse(b[j], c[j] + x[j-1]) along the last axis, summed in
    ``lax.associative_scan``'s own tree: combine the pairs (2k, 2k+1), scan
    the halves recursively, take each odd output from the recursion and
    out[2k] = combine(scan[k-1], x[2k]), out[0] = x[0].  The elements are
    (c, b) and combine(l, r) = (cl + cr, lse(br, cr + bl)); the c's partial
    sums are float adds in that tree.  A prefix's value depends on the
    columns up to it only, so the row's width does not change its bits."""

    def combine(left, right):
        (cl, bl), (cr, br) = left, right
        return cl + cr, lse_pair(br, cr + bl, mode)

    def scan(c, b):
        n = c.shape[-1]
        if n < 2:
            return c, b
        rc, rb = combine((c[..., 0:-1:2], b[..., 0:-1:2]),
                         (c[..., 1::2], b[..., 1::2]))
        oc, ob = scan(rc, rb)
        if n % 2 == 0:
            ec, eb = combine((oc[..., :-1], ob[..., :-1]),
                             (c[..., 2::2], b[..., 2::2]))
        else:
            ec, eb = combine((oc, ob), (c[..., 2::2], b[..., 2::2]))
        ec = torch.cat([c[..., :1], ec], dim=-1)
        eb = torch.cat([b[..., :1], eb], dim=-1)
        return _interleave(ec, oc), _interleave(eb, ob)

    return scan(c, b)[1]


def _rows_fill(s1, s2, n1, n2, ms, ins, scal, mode):
    """``_pairhmm_rows`` for a batch in the pass's coordinates: (FM, FI, FD)
    (P, N1, N2), -inf outside [0, n1-2] x [0, n2-2] (FM[0, 0] = 0)."""
    P, N1 = s1.shape
    N2 = s2.shape[1]
    dev = s1.device
    m2m, m2i, ext, init_m, init_i = scal.unbind()
    jj = torch.arange(N2, device=dev)
    n1l, n2l = n1.long()[:, None], n2.long()[:, None]
    msflat = ms.reshape(P, NB * NB)
    ins2 = ins.gather(1, s2)
    neg = torch.full((P, N2), NEG_INF, device=dev)
    fm_p = fi_p = fd_p = neg
    FM, FI, FD = [], [], []
    for i in range(N1):
        row_ok = i < n1l - 1
        valid_j = (jj < n2l - 1) & row_ok
        x1i = s1[:, i:i + 1]
        msr = msflat.gather(1, x1i * NB + s2)
        # match: from (i-1, j-1)
        begins_m = (i == 1) & (jj == 1)
        tm = _lse3(_shift_right(fm_p) + torch.where(begins_m, init_m, m2m),
                   _shift_right(fi_p) + m2i, _shift_right(fd_p) + m2i, mode)
        fm = torch.where((i >= 1) & (jj >= 1) & valid_j, tm + msr, NEG_INF)
        fm = torch.where((i == 0) & (jj == 0) & row_ok, 0.0, fm)
        # insert (gap in seq 2): from (i-1, j)
        begins_i = (i == 1) & (jj == 0)
        ti = lse_pair(fm_p + torch.where(begins_i, init_i, m2i), fi_p + ext,
                      mode)
        fi = torch.where((i >= 1) & valid_j, ti + ins.gather(1, x1i), NEG_INF)
        # delete (gap in seq 1): the within-row linear recurrence
        begins_d = (i == 0) & (jj == 1)
        a = _shift_right(fm) + torch.where(begins_d, init_i, m2i)
        live = (jj >= 1) & valid_j
        b = torch.where(live, a + ins2, NEG_INF)
        c = torch.where(live, ext + ins2, NEG_INF)
        fd = _linrec_lse(b, c, mode)
        fm_p, fi_p, fd_p = fm, fi, fd
        FM.append(fm)
        FI.append(fi)
        FD.append(fd)
    return (torch.stack(FM, dim=1), torch.stack(FI, dim=1),
            torch.stack(FD, dim=1))


def _reverse2d(M, n1, n2):
    """R[i, j] = M[n1-1-i, n2-1-j] inside [0, n1) x [0, n2), -inf outside."""
    P, N1, N2 = M.shape
    dev = M.device
    i = torch.arange(N1, device=dev)[None, :, None]
    j = torch.arange(N2, device=dev)[None, None, :]
    n1l, n2l = n1.long()[:, None, None], n2.long()[:, None, None]
    ri = (n1l - 1 - i).clamp(0, N1 - 1).expand(P, N1, N2)
    rj = (n2l - 1 - j).clamp(0, N2 - 1).expand(P, N1, N2)
    out = M.gather(1, ri).gather(2, rj)
    return torch.where((i < n1l) & (j < n2l), out, NEG_INF)


def _shift11(M):
    out = torch.full_like(M, NEG_INF)
    out[:, :-1, :-1] = M[:, 1:, 1:]
    return out


def _corner(planes, n1, n2):
    """(P, 3): the three planes at (max(n1-2, 0), max(n2-2, 0))."""
    P = n1.shape[0]
    p = torch.arange(P, device=n1.device)
    i = (n1.long() - 2).clamp(min=0)
    j = (n2.long() - 2).clamp(min=0)
    return torch.stack([x[p, i, j] for x in planes], dim=1)


def _rows_pass(x1, x2, n1, n2, ms, ins, scal, backward, mode):
    """One pass of the plain row scan, the kernel's contract: (plane (P, N1,
    N2), corner (P, 3))."""
    s1 = _pass_seqs(x1, n1, backward)
    s2 = _pass_seqs(x2, n2, backward)
    planes = _rows_fill(s1, s2, n1, n2, ms, ins, scal, mode)
    corner = _corner(planes, n1, n2)
    if not backward:
        return planes[0], corner
    m2m, m2i = scal[0], scal[1]
    BM1, BI1, BD1 = (_shift11(_reverse2d(x, n1, n2)) for x in planes)
    N1, N2 = x1.shape[1], x2.shape[1]
    i = torch.arange(N1, device=x1.device)[None, :, None]
    j = torch.arange(N2, device=x1.device)[None, None, :]
    ends = ((i + 1 == n1.long()[:, None, None] - 1)
            & (j + 1 == n2.long()[:, None, None] - 1))
    ssum = _lse3(BM1 + torch.where(ends, 0.0, m2m), m2i + BI1, m2i + BD1,
                 mode)
    return ssum, corner


def pairhmm_rows_plain(x1, x2, n1, n2, ms, ins, scal, backward,
                       mode="exact"):
    return _rows_pass(x1, x2, n1, n2, ms, ins, scal, backward,
                      check_mode(mode))


def rows_plan(N2, mode="exact"):
    """The kernel's launch of a pass at N2 columns, as
    ``csrc/pairhmm_rows.cu`` chooses it on this card: dict(W, T, C, R,
    scratch) (W columns as C blocks of T threads of R columns each, a
    cluster a pair; ``scratch`` when the runs live in global memory)."""
    plan = (ctypes.c_int * 5)()
    _build.library().call("rna_pairhmm_rows_plan", N2, int(mode == "fast"),
                          plan)
    return dict(zip(("W", "T", "C", "R", "scratch"), plan))


def _rows_cuda(x1, x2, n1, n2, ms, ins, scal, backward, mode):
    dev = x1.device
    P, N1 = x1.shape
    N2 = x2.shape[1]
    ins_ = dict(x1=x1, x2=x2, n1=n1, n2=n2, ms=ms, ins=ins, scal=scal)
    shapes = dict(x1=(P, N1), x2=(P, N2), n1=(P,), n2=(P,), ms=(P, NB, NB),
                  ins=(P, NB), scal=(5,))
    _build.check_cuda("pairhmm_rows", ins_, shapes, dev,
                      ints=("x1", "x2", "n1", "n2"))
    plan = rows_plan(N2, mode)
    scratch = torch.empty((P, SCRATCH_ROWS, plan["W"]) if plan["scratch"]
                          else (0,), device=dev)
    out = PA._plane(P, N1, N2, dev)
    corner = torch.full((P, 3), NEG_INF, device=dev)
    args = [x1, x2, n1, n2, ms, ins, scal, out, corner]
    _build.library().call(
        "rna_pairhmm_rows", *[_build.ptr(t) for t in args],
        _build.ptr(scratch) if plan["scratch"] else None, P, N1, N2,
        int(backward), int(mode == "fast"), _build.stream_ptr(dev),
    )
    return out, corner


launches = _build.LaunchCounter("pairhmm_rows")


def pairhmm_rows(x1, x2, n1, n2, ms, ins, scal, backward, mode="exact"):
    """K22, one row-scan pass over P pairs.

    x1 (P, N1), x2 (P, N2): int32 sentinel-wrapped bases (forward
    coordinates), any N1 and N2; n1, n2: (P,) int32 lengths,
    at least 2; ms (P, 5, 5) and ins (P, 5) float32 score tables; scal
    (5,) [m2m, m2i, ext, init_m, init_i].  ``mode`` "exact" or "parity"
    (the cubic log-add) or "fast" (the hardware one).  Returns (plane
    (P, N1, N2), corner (P, 3)): forward, the match states FM[i, j] and
    the M/I/D sums at (n1-2, n2-2); backward (the pair reversed, zero
    init scores), the posterior context ssum[i, j] in forward
    coordinates.  -inf outside [0, n1-2] x [0, n2-2]."""
    mode = check_mode(mode)
    dev = x1.device
    if dev.type == "cpu":
        return _rows_pass(x1, x2, n1, n2, ms, ins, scal, backward, mode)
    if dev.type != "cuda":
        raise ValueError(f"pairhmm_rows: no kernel for device {dev}")
    out = _rows_cuda(x1, x2, n1, n2, ms, ins, scal, backward, mode)
    launches.add()
    return out
