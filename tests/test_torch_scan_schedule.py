"""The tree schedule of kernels K20/K21 (``scan_reduce`` in
``csrc/fold_scan.cu``) replayed in plain PyTorch on the CPU.

Thread ``tid`` of a block of T holds the terms k = tid + m T, m < L (the
least power of two with L T >= the tree's extent).  Under the cubic modes
it takes its leaves in bit-reversed order of m and closes the halving tree
over them with a stack of one partial sum a level; then the block halves
over its threads.  That must be ``numerics.lse_reduce``'s tree bit for bit
at every L the kernels may use (1 to ``fold_scan.MAX_LEAVES``): it is what
lets K21 take the 3N-wide context tree past one leaf set a thread.  Under
"fast" a thread keeps a running max and sum of exp(x - max) and the block
merges the pairs: within 1e-6 of the max-form.  Also: ``fold_scan.threads``
covers every extent up to 3 MAX_N and refuses the next.
"""

import numpy as np
import pytest
import torch

from rna_algos_tpu_torch.numerics import lse_pair, lse_reduce
from rna_algos_tpu_torch.ops import fold_scan as FS

NEG_INF = float("-inf")
# (threads, extent): L = 1, 2, 16, 32, 64 and 128 leaves a thread; the
# window (961), K21's context tree at N = 384 and 1536 and at MAX_N
CASES = ((64, 961), (1024, 961), (32, 1000), (64, 1152 - 7), (32, 1152),
         (512, 3 * 1536 - 5), (64, 3 * 1536), (1024, 3 * FS.MAX_N))


def _terms(extent, seed, rows=8):
    """Rows of log-space terms, with runs of -inf (the identity): in
    [-3, 3], where every term moves the sum and so the order shows in the
    last bits, and in [-60, 40]."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3.0, 3.0, (rows, extent)).astype(np.float32)
    x[rows // 2:] = rng.uniform(-60.0, 40.0, (rows - rows // 2, extent))
    for r in range(rows):
        lo = int(rng.integers(0, extent))
        x[r, lo:int(rng.integers(lo, extent + 1))] = -np.inf
    return torch.as_tensor(x)


def _leaves(x, T):
    """The terms (R, extent) as [r, m, tid], padded with -inf to L T."""
    R, extent = x.shape
    lg = 0
    while (T << lg) < extent:
        lg += 1
    pad = torch.full((R, (T << lg) - extent), NEG_INF)
    return torch.cat([x, pad], 1).view(R, 1 << lg, T), lg


def kernel_tree(x, T, mode):
    """scan_reduce's cubic order: per thread, the leaves in bit-reversed
    order of m through a stack of partial sums (a -inf right operand
    leaves the left one), then the halving tree over the threads."""
    v, lg = _leaves(x, T)
    stk = [None] * (lg + 1)
    for q in range(1 << lg):
        m = int(format(q, f"0{lg}b")[::-1], 2) if lg else 0
        y = v[:, m].clone()
        z = 0
        while (q >> z) & 1:
            y = torch.where(y != NEG_INF, lse_pair(stk[z], y, mode), stk[z])
            z += 1
        stk[z] = y
    while y.shape[1] > 1:
        h = y.shape[1] // 2
        y = lse_pair(y[:, :h], y[:, h:], mode)
    return y[:, 0]


def kernel_tree_fast(x, T):
    """scan_reduce's fast order: a running (max, sum of exp(x - max)) a
    thread over m, then the threads' pairs merged by halving."""
    v, _ = _leaves(x, T)
    mx = torch.full((v.shape[0], T), NEG_INF)
    sm = torch.zeros(v.shape[0], T)
    for m in range(v.shape[1]):
        y = v[:, m]
        live = y != NEG_INF
        up = live & (y > mx)
        sm = torch.where(up, sm * torch.exp(mx - y) + 1.0,
                         torch.where(live, sm + torch.exp(y - mx), sm))
        mx = torch.where(up, y, mx)
    while mx.shape[1] > 1:
        h = mx.shape[1] // 2
        a, b = mx[:, :h], mx[:, h:]
        M = torch.maximum(a, b)
        both = sm[:, :h] * torch.exp(a - M) + sm[:, h:] * torch.exp(b - M)
        sm = torch.where(M != NEG_INF, both, sm[:, :h])
        mx = M
    m, s = mx[:, 0], sm[:, 0]
    return torch.where(torch.isfinite(m), m + torch.log(s),
                       torch.full_like(m, NEG_INF))


@pytest.mark.parametrize("mode", ["exact", "parity"])
@pytest.mark.parametrize("T,extent", CASES)
def test_kernel_tree_is_lse_reduce(T, extent, mode):
    x = _terms(extent, seed=T + extent)
    got = kernel_tree(x, T, mode)
    want = lse_reduce(x, -1, mode)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("T,extent", CASES)
def test_kernel_tree_fast(T, extent):
    x = _terms(extent, seed=T + extent + 1)
    got = kernel_tree_fast(x, T)
    want = lse_reduce(x, -1, "fast")
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    fin = torch.isfinite(want)
    assert bool(((got - want)[fin].abs()
                 <= 1e-6 * want[fin].abs().clamp(min=1.0)).all())


def test_kernel_tree_all_identity():
    x = torch.full((2, 1000), NEG_INF)
    assert (kernel_tree(x, 32, "exact") == NEG_INF).all()
    assert (kernel_tree_fast(x, 32) == NEG_INF).all()


def test_threads_cover_every_extent_up_to_max_n():
    for extent in (1, 961, 1024, 16 * 1024, 16 * 1024 + 1, 3 * 5462,
                   3 * FS.MAX_N):
        T = FS.threads(extent)
        assert FS.MIN_THREADS <= T <= FS.MAX_THREADS and not T & (T - 1)
        assert T * FS.MAX_LEAVES >= extent
        assert T == FS.MAX_THREADS or T * FS.LEAVES >= extent
    with pytest.raises(ValueError, match="exceeds one block"):
        FS.threads(3 * FS.MAX_N + 3)
