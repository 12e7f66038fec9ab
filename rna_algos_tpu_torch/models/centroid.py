"""Gamma-centroid MEA structure estimator (``rna_algos_tpu.models.centroid``).

The fill is a max-plus wavefront over spans with the records and the gamma
grid as batch dimensions (``ops.mea_fill``: kernel K23 on the card, the
plain version on the CPU), bitwise the JAX fill, because the host
traceback re-derives every choice by float32 equality.  The traceback runs
on the host: in C (``_native``, one call a chunk of records and gammas)
for the card's paths, the NumPy loop ``traceback`` for the CPU's.
"""

import contextlib
import os

import numpy as np
import torch

from .. import _native
from ..ops import mea_fill as MF
from ..utils.output import _fmt, fold_str, fold_strs

# Reference CLI gamma grid: 2^-7 .. 2^10.
MIN_POW_2 = -7
MAX_POW_2 = 10
DEFAULT_GAMMAS = tuple(float(2.0 ** k) for k in range(MIN_POW_2, MAX_POW_2 + 1))


def mea_fill_gammas(bpp, gammas, N):
    """(N, N) square BPP + (G,) gammas -> (G, N, N) square MEA fills: the
    one-record case of ``ops.mea_fill.mea_fill_batch`` (K23 on a CUDA
    tensor)."""
    if tuple(bpp.shape) != (N, N):
        raise ValueError(f"mea_fill_gammas: BPP of shape {tuple(bpp.shape)}, "
                         f"expected {(N, N)}")
    return MF.mea_fill_batch(bpp[None], gammas)[0]


def mea_fill(bpp, gamma, N):
    """One gamma: (N, N) square fill."""
    return mea_fill_gammas(bpp, [gamma], N)[0]


def traceback(M, bpp, gamma, n):
    """Stack traceback by float-equality re-derivation on the host: the
    plain version of ``_native.traceback``.

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
    (pairs, expected accuracy); the native traceback for a CUDA tensor."""
    tb = _native.traceback if _native.on_card(bpp.device) else traceback
    M = mea_fill(bpp, gamma, bpp.shape[0]).cpu().numpy()
    return tb(M, bpp.cpu().numpy(), gamma, n)


# The fills of one K23 launch, (records, G, N, N) float32, stay under this
# many bytes (one record a launch where a record's fills alone exceed it).
MEA_FILL_CHUNK_BYTES = 256 << 20


def fill_chunks(R, G, N):
    """The (start, stop) record ranges of ``centroid_structures``' K23
    launches for R records of bucket N and G gammas: at most
    MEA_FILL_CHUNK_BYTES of fills a launch, at least one record."""
    step = max(1, MEA_FILL_CHUNK_BYTES // (G * N * N * 4))
    return [(c, min(c + step, R)) for c in range(0, R, step)]


def centroid_structures(results, gammas, device, timer=None, tag=""):
    """{gamma: [dot-bracket per record]} from (bpp, presence, n) results:
    the records grouped by ``pick_bucket(n)``, each group's BPPs padded to
    its bucket and filled for all gammas at once on ``device`` (one launch
    a chunk of ``fill_chunks``), the traceback on the host: on a CUDA
    device ``_native.traceback_batch`` (one call a chunk), on the CPU the
    plain ``traceback``, any other device raises; the output in the
    records' order.  ``timer``: a ``utils.trace.PhaseTimer`` that then
    times the fills (phase ``"mea_fill" + tag``, CUDA events on a CUDA
    device), their copy to the host (``"fill_copy" + tag``) and the
    tracebacks (``"traceback" + tag``)."""
    from ..parallel.runner import pick_bucket

    native = _native.on_card(device)

    def phase(name, records):
        if timer is None:
            return contextlib.nullcontext()
        return timer.phase(name + tag, items=records * len(gammas),
                           device=device if name == "mea_fill" else None)

    groups = {}
    for k, (_bpp, _presence, n) in enumerate(results):
        groups.setdefault(pick_bucket(n), []).append(k)
    out = {g: [None] * len(results) for g in gammas}
    for N, ks in groups.items():
        for c0, c1 in fill_chunks(len(ks), len(gammas), N):
            chunk = ks[c0:c1]
            padded = np.zeros((len(chunk), N, N), dtype=np.float32)
            for r, k in enumerate(chunk):
                bpp, _presence, n = results[k]
                padded[r, :n, :n] = bpp
            with phase("mea_fill", len(chunk)):
                fills = MF.mea_fill_batch(
                    torch.as_tensor(padded, device=device), gammas)
            with phase("fill_copy", len(chunk)):
                fills = fills.cpu().numpy()
            with phase("traceback", len(chunk)):
                ns = [results[k][2] for k in chunk]
                if native:
                    strs = fold_strs(*_native.traceback_batch(
                        fills, padded, ns, gammas), ns, N)
                else:
                    strs = [[fold_str(traceback(M, padded[r], g, n)[0], n)
                             for g, M in zip(gammas, fills[r])]
                            for r, n in enumerate(ns)]
                for k, recs in zip(chunk, strs):
                    for g, s in zip(gammas, recs):
                        out[g][k] = s
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
