"""Diagonal-layout helpers of the slice (``rna_algos_tpu.ops.diag``).

``skew_pq`` and ``unskew_pq`` are the plain versions of kernel K3
(``ops/pallas_skew.py``): pure permutations with a fill, so every port of
them is bitwise equal.  All functions take a leading batch dimension.
"""

import torch


def skew_pq(M, fill=0.0):
    """V[..., p, d] = M[..., p, p + d]; p + d >= Q -> fill."""
    P, Q = M.shape[-2:]
    p = torch.arange(P, device=M.device)[:, None]
    d = torch.arange(Q, device=M.device)[None, :]
    col = p + d
    idx = torch.broadcast_to(col.clamp(max=Q - 1), M.shape)
    vals = torch.gather(M, -1, idx)
    return torch.where(col < Q, vals, torch.full_like(vals, fill))


def unskew_pq(M, fill=0.0):
    """V[..., p, c] = M[..., p, c - p]; c < p -> fill (right-skew of each
    row by its row index; columns keep the input width)."""
    P, Q = M.shape[-2:]
    p = torch.arange(P, device=M.device)[:, None]
    c = torch.arange(Q, device=M.device)[None, :]
    col = c - p
    idx = torch.broadcast_to(col.clamp(min=0), M.shape)
    vals = torch.gather(M, -1, idx)
    return torch.where(col >= 0, vals, torch.full_like(vals, fill))


def shift_pq(M, dp, dq, fill=0.0):
    """OUT[..., p, q] = M[..., p + dp, q + dq] with ``fill`` outside
    (static shifts; ``diag.shift_di`` and the ``sh`` helper of the merged
    precompute)."""
    P, Q = M.shape[-2:]
    out = torch.full_like(M, fill)
    p0, p1 = max(0, -dp), min(P, P - dp)
    q0, q1 = max(0, -dq), min(Q, Q - dq)
    if p0 < p1 and q0 < q1:
        out[..., p0:p1, q0:q1] = M[..., p0 + dp:p1 + dp, q0 + dq:q1 + dq]
    return out
