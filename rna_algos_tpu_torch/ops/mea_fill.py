"""Kernel K23: the gamma-centroid MEA fill
(``rna_algos_tpu.models.centroid.mea_fill``, vmapped over the gamma grid by
``mea_fill_gammas``; an XLA loop there, no Pallas kernel).

``mea_fill_batch`` launches ``csrc/mea_fill.cu`` for CUDA tensors and runs
the plain version (``mea_fill_batch_plain``) for CPU tensors.  The kernel
takes a plan (``plan``): the shared form, one block a fill with the
triangle in shared memory, up to N = 332; past it the cluster form, a
cluster of C blocks a fill with the triangle in a global workspace.  The plain
version keeps the JAX fill's float32 expressions and their order
(``(m_in + gamma * p) - 1.0`` and ``P + R``, no fused or reassociated
form), because the host traceback re-derives every choice by float32
equality; the kernel is bitwise the same.
"""

import ctypes
import functools

import numpy as np
import torch

from . import _build
from ..constants import NEG_INF
from ..utils.platform import on_cuda

# RNA_MEA_SHARED_BYTES and RNA_MEA_K in csrc/mea_fill.cu: a fill's live
# triangle, with a band of K bpp values a lane, up to this size is kept in
# shared memory (N <= 332), past it in a global workspace.
SHARED_BYTES = 232448
BAND = 8

launches = _build.LaunchCounter("mea_fill")


def state_in_shared(N):
    """Whether K23 keeps a bucket-N fill's state in shared memory (the
    shared form); past it the cluster form keeps it in a workspace."""
    return (N * (N + 1) // 2 + BAND * N) * 4 <= SHARED_BYTES


@functools.lru_cache(maxsize=None)
def plan(R, G, N):
    """K23's launch of R x G fills at bucket N on the current card:
    (form, threads a block, blocks a fill), form 0 the shared form and 1
    the cluster form (``rna_mea_fill_plan``)."""
    out = (ctypes.c_int * 3)()
    _build.library().call("rna_mea_fill_plan", R, G, N, out)
    return tuple(out)


def _gammas(gammas, device):
    """The gamma grid as the float32 values ``np.asarray`` gives, on
    ``device`` (kept: a copy to the card on every call would wait for the
    stream)."""
    return _gammas_on(tuple(np.asarray(gammas, dtype=np.float32).tolist()),
                      str(device))


@functools.lru_cache(maxsize=64)
def _gammas_on(values, device):
    return torch.tensor(values, dtype=torch.float32, device=device)


def mea_fill_batch_plain(bpps, gammas):
    """(R, N, N) square BPPs + (G,) gammas -> (R, G, N, N) square fills.

    State is kept in left layout P[r, g, i, d] = M(i, i + d) and right
    layout Q[r, g, j, c] = M(j - c, j), as in the JAX scan."""
    dev = bpps.device
    R, N, _ = bpps.shape
    G = len(gammas)
    gam = _gammas(gammas, dev).view(1, G, 1)
    i = torch.arange(N, device=dev)[:, None]
    dd = torch.arange(N, device=dev)[None, :]
    j = (i + dd).clamp(max=N - 1)
    bpp_left = torch.where(i + dd < N,
                           torch.gather(bpps, 2, j.expand(R, N, N)),
                           torch.zeros((), device=dev))
    neg = torch.full((), NEG_INF, device=dev)
    zcol = torch.zeros((R, G, 1), device=dev)
    P = torch.zeros((R, G, N, N), device=dev)
    Q = torch.full((R, G, N, N), NEG_INF, device=dev)
    for d in range(N):
        if d == 0:
            m_new = torch.zeros((R, G, N), device=dev)
        else:
            c2 = P[..., d - 1]
            c1 = torch.cat([c2[..., 1:], zcol], dim=2)
            p = bpp_left[:, None, :, d]
            m_in = (
                torch.cat([P[:, :, 1:, d - 2], zcol], dim=2) if d >= 2
                else torch.zeros((R, G, N), device=dev)
            )
            c3 = torch.where(p > 0.0, (m_in + gam * p) - 1.0, neg)
            c4 = torch.full((R, G, N), NEG_INF, device=dev)
            if d >= 2:
                # t in [1, d-1]: M(i, i+t) + M(i+t+1, i+d), for i + d < N
                terms = P[..., :N - d, 1:d] + Q[..., d:, :d - 1].flip(-1)
                c4[..., :N - d] = terms.max(dim=3).values
            m_new = torch.maximum(torch.maximum(c1, c2), torch.maximum(c3, c4))
        P[..., d] = m_new
        Q[..., d:, d] = m_new[..., :N - d]
    # square[r, g, i, j] = P[r, g, i, j - i] for j >= i, else 0
    jj = torch.arange(N, device=dev)[None, :]
    col = (jj - i).clamp(min=0).expand(R, G, N, N)
    return torch.where(jj >= i, torch.gather(P, 3, col),
                       torch.zeros((), device=dev))


def _fills(R, G, N, device):
    """K23's output, uninitialised: the kernel writes every cell."""
    return torch.empty((R, G, N, N), dtype=torch.float32, device=device)


def mea_fill_batch(bpps, gammas, launch=None):
    """(R, N, N) float32 square BPPs, all padded to one bucket N, + G gammas
    -> (R, G, N, N) square MEA fills, zero below the diagonal.  ``launch``:
    a (form, threads, blocks) plan other than ``plan``'s (the kernel
    refuses one its form cannot run)."""
    device = bpps.device
    if device.type == "cpu":
        return mea_fill_batch_plain(bpps, gammas)
    if not on_cuda(device):
        raise ValueError(f"mea_fill_batch: no kernel for device {device}")
    R, N, _ = bpps.shape
    gam = _gammas(gammas, device)
    G = gam.numel()
    _build.check_cuda("mea_fill_batch", {"bpps": bpps, "gammas": gam},
                      {"bpps": (R, N, N), "gammas": (G,)}, device)
    form, T, C = launch or plan(R, G, N)
    out = _fills(R, G, N, device)
    work = torch.empty(R * G * N * (N + 1) // 2 if form else 0,
                       dtype=torch.float32, device=device)
    _build.library().call(
        "rna_mea_fill", _build.ptr(bpps), _build.ptr(gam), _build.ptr(out),
        _build.ptr(work), R, G, N, form, T, C, _build.stream_ptr(device),
    )
    launches.add()
    return out
