"""Gamma-centroid MEA structure estimator (``rna_algos_tpu.models.centroid``).

The fill is a max-plus wavefront over spans with the gamma grid as a batch
dimension; it keeps the JAX fill's float32 expressions and their order
(``(m_in + gamma * p) - 1.0`` and ``P + R``, no fused or reassociated
form), because the host traceback re-derives every choice by float32
equality.  The traceback is a NumPy loop on the host.
"""

import contextlib
import os

import numpy as np
import torch

from ..constants import NEG_INF
from ..utils.output import _fmt, fold_str

# Reference CLI gamma grid: 2^-7 .. 2^10.
MIN_POW_2 = -7
MAX_POW_2 = 10
DEFAULT_GAMMAS = tuple(float(2.0 ** k) for k in range(MIN_POW_2, MAX_POW_2 + 1))


def mea_fill_gammas(bpp, gammas, N):
    """(N, N) square BPP + (G,) gammas -> (G, N, N) square MEA fills.

    State is kept in left layout P[g, i, d] = M(i, i + d) and right layout
    Q[g, j, c] = M(j - c, j), as in the JAX scan."""
    dev = bpp.device
    G = len(gammas)
    gam = torch.as_tensor(np.asarray(gammas, dtype=np.float32), device=dev)
    gam = gam.view(G, 1)
    i = torch.arange(N, device=dev)[:, None]
    dd = torch.arange(N, device=dev)[None, :]
    j = (i + dd).clamp(max=N - 1)
    bpp_left = torch.where(i + dd < N, torch.gather(bpp, 1, j.expand(N, N)),
                           torch.zeros((), device=dev))
    neg = torch.full((), NEG_INF, device=dev)
    zcol = torch.zeros((G, 1), device=dev)
    P = torch.zeros((G, N, N), device=dev)
    Q = torch.full((G, N, N), NEG_INF, device=dev)
    for d in range(N):
        if d == 0:
            m_new = torch.zeros((G, N), device=dev)
        else:
            c2 = P[:, :, d - 1]
            c1 = torch.cat([c2[:, 1:], zcol], dim=1)
            p = bpp_left[:, d][None, :]
            m_in = (
                torch.cat([P[:, 1:, d - 2], zcol], dim=1) if d >= 2
                else torch.zeros((G, N), device=dev)
            )
            c3 = torch.where(p > 0.0, (m_in + gam * p) - 1.0, neg)
            c4 = torch.full((G, N), NEG_INF, device=dev)
            if d >= 2:
                # t in [1, d-1]: M(i, i+t) + M(i+t+1, i+d), for i + d < N
                terms = P[:, :N - d, 1:d] + Q[:, d:, :d - 1].flip(-1)
                c4[:, :N - d] = terms.max(dim=2).values
            m_new = torch.maximum(torch.maximum(c1, c2), torch.maximum(c3, c4))
        P[:, :, d] = m_new
        Q[:, d:, d] = m_new[:, :N - d]
    # square[g, i, j] = P[g, i, j - i] for j >= i, else 0
    jj = torch.arange(N, device=dev)[None, :]
    col = (jj - i).clamp(min=0).expand(G, N, N)
    return torch.where(jj >= i, torch.gather(P, 2, col),
                       torch.zeros((), device=dev))


def mea_fill(bpp, gamma, N):
    """One gamma: (N, N) square fill."""
    return mea_fill_gammas(bpp, [gamma], N)[0]


def traceback(M, bpp, gamma, n):
    """Stack traceback by float-equality re-derivation on the host.

    Returns (pairs, expected accuracy), as ``rna_algos_tpu`` does."""
    M = np.asarray(M, dtype=np.float32)
    bpp = np.asarray(bpp, dtype=np.float32)
    gamma = np.float32(gamma)
    one = np.float32(1.0)
    pairs = []
    stack = [(0, n - 1)]
    while stack:
        i, j = stack.pop()
        if j <= i:
            continue
        m = M[i, j]
        if m == np.float32(0.0):
            continue
        if m == M[i + 1, j]:
            stack.append((i + 1, j))
        elif m == M[i, j - 1]:
            stack.append((i, j - 1))
        elif bpp[i, j] > 0.0 and m == np.float32(
            (M[i + 1, j - 1] + gamma * bpp[i, j]) - one
        ):
            stack.append((i + 1, j - 1))
            pairs.append((i, j))
        else:
            for k in range(i + 1, j):
                if m == np.float32(M[i, k] + M[k + 1, j]):
                    stack.append((i, k))
                    stack.append((k + 1, j))
                    break
    return pairs, float(M[0, n - 1])


def centroid_fold(bpp, n, gamma):
    """Full gamma-centroid estimate from a dense (N, N) BPP tensor:
    (pairs, expected accuracy)."""
    M = mea_fill(bpp, gamma, bpp.shape[0]).cpu().numpy()
    return traceback(M, bpp.cpu().numpy(), gamma, n)


def centroid_structures(results, gammas, device, timer=None, tag=""):
    """{gamma: [dot-bracket per record]} from (bpp, presence, n) results:
    each record's BPPs padded to ``pick_bucket(n)``, the fill for all
    gammas at once on ``device``, the traceback on the host.  ``timer``: a
    ``utils.trace.PhaseTimer`` that then times the fills (phase
    ``"mea_fill" + tag``, CUDA events on a CUDA device) and the tracebacks
    (``"traceback" + tag``)."""
    from ..parallel.runner import pick_bucket

    def phase(name):
        if timer is None:
            return contextlib.nullcontext()
        return timer.phase(name + tag, items=len(gammas),
                           device=device if name == "mea_fill" else None)

    out = {g: [] for g in gammas}
    for bpp, _presence, n in results:
        N = pick_bucket(n)
        padded = np.zeros((N, N), dtype=np.float32)
        padded[:n, :n] = bpp
        with phase("mea_fill"):
            fills = mea_fill_gammas(
                torch.as_tensor(padded, device=device), gammas, N
            ).cpu().numpy()
        with phase("traceback"):
            for g, M in zip(gammas, fills):
                pairs, _ = traceback(M, padded, g, n)
                out[g].append(fold_str(pairs, n))
    return out


def gamma_file_name(gamma):
    return f"centroid_threshold={_fmt(gamma)}.fa"


def write_gamma_files(out_dir, structures):
    """One ``centroid_threshold={gamma}.fa`` a gamma of ``structures``
    (``centroid_structures``' dict) in ``out_dir``: ``>{index}`` records,
    the bytes of the JAX package's ``write_gamma_file``."""
    for gamma, recs in structures.items():
        with open(os.path.join(out_dir, gamma_file_name(gamma)), "w") as f:
            f.write("\n".join(f">{k}\n{s}" for k, s in enumerate(recs)))
