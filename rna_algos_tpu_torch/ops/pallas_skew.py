"""Kernel K3: batched diagonal skew (``rna_algos_tpu.ops.pallas_skew``).

``skew_pq_batch`` launches ``csrc/skew.cu`` for CUDA tensors and runs the
plain version (``diag.skew_pq`` / ``diag.unskew_pq``) for CPU tensors.
"""

import ctypes

import torch

from . import _build
from . import diag
from ..utils.platform import on_cuda

MAX_TABLES = 32  # RNA_SKEW_MAX_TABLES in csrc/skew.cu (Turner skews 18)


launches = _build.LaunchCounter("skew")


def skew_pq_batch_plain(mats, inv=False):
    fn = diag.unskew_pq if inv else diag.skew_pq
    return [fn(m, 0.0) for m in mats]


def skew_pq_batch(mats, inv=False):
    """Skew (B, N, N) [p, q] tables to [p, d] (fill 0.0), in input order.

    ``inv=True`` applies the inverse permutation: out[i, j] = in[i, j - i]
    for j >= i, 0 below the diagonal (the [i, d] -> square conversion)."""
    mats = list(mats)
    device = mats[0].device
    if device.type == "cpu":
        return skew_pq_batch_plain(mats, inv=inv)
    if not on_cuda(device):
        raise ValueError(f"skew_pq_batch: no kernel for device {device}")
    T = len(mats)
    if T > MAX_TABLES:
        raise ValueError(f"skew_pq_batch: {T} tables, at most {MAX_TABLES}")
    B, N, _ = mats[0].shape
    _build.check_cuda(
        "skew_pq_batch",
        {f"table{k}": m for k, m in enumerate(mats)},
        {f"table{k}": (B, N, N) for k in range(T)},
        device,
    )
    outs = [torch.empty_like(m) for m in mats]
    ins = (ctypes.c_void_p * T)(*[m.data_ptr() for m in mats])
    ots = (ctypes.c_void_p * T)(*[r.data_ptr() for r in outs])
    _build.library().call(
        "rna_skew", ins, ots, T, B, N, int(inv), _build.stream_ptr(device)
    )
    launches.add()
    return outs
