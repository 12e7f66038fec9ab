"""The port's native host runtime (``rna_algos_tpu._native``): the centroid
traceback and the ``i,j,p `` probability text in C (``csrc/native_host.c``).

The card's paths run it (``models.centroid.centroid_structures``, the
``mccaskill`` and ``durbin`` CLIs); the CPU's run the plain Python versions
(``models.centroid.traceback``, ``utils.output.probs2str``), which the
tests hold it against.  The library is built at first use by the host C
compiler (``cc``) with a plain C interface and loaded with ``ctypes``, into
``_build/`` under a name that carries a hash of the source and the flags.
``-ffp-contract=off`` keeps ``M + gamma * bpp - 1`` rounded twice, as the
fill and the Python traceback round it.  A failed build raises; nothing
falls back to Python.  Nothing here runs at import time.
"""

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from .ops._build import LaunchCounter

PKG_DIR = pathlib.Path(__file__).resolve().parent
SOURCE = PKG_DIR / "csrc" / "native_host.c"
BUILD_DIR = PKG_DIR / "_build"
CC_FLAGS = ("-O2", "-std=c11", "-shared", "-fPIC", "-ffp-contract=off")

# one call a chunk of (records, gammas) fills: centroid_structures' calls
traceback_calls = LaunchCounter("native_traceback")

_P = ctypes.c_void_p
_I = ctypes.c_int32
_L = ctypes.c_int64


def library_name(source, flags):
    """The library's file name for C source bytes ``source`` built with
    ``flags``."""
    h = hashlib.sha256(source)
    h.update(" ".join(flags).encode())
    return f"librna_native_{h.hexdigest()[:16]}.so"


def build(build_dir=None, flags=CC_FLAGS):
    """The path of the library built from SOURCE with ``flags`` in
    ``build_dir`` (BUILD_DIR when None), compiled there first if it is not
    yet.  The compiler's temporary files go to a directory in
    ``build_dir`` that is removed after; a failed build raises with the
    compiler's output."""
    cc = shutil.which("cc")
    if cc is None:
        raise RuntimeError("no host C compiler (cc) on PATH: it builds "
                           "rna_algos_tpu_torch's native host runtime")
    build_dir = pathlib.Path(BUILD_DIR if build_dir is None else build_dir)
    build_dir.mkdir(exist_ok=True)
    so = build_dir / library_name(SOURCE.read_bytes(), flags)
    if so.exists():
        return so
    work = pathlib.Path(tempfile.mkdtemp(dir=build_dir))
    try:
        tmp = work / so.name
        res = subprocess.run([cc, *flags, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True,
                             env=dict(os.environ, TMPDIR=str(work)))
        if res.returncode:
            raise RuntimeError(f"cc failed to build {SOURCE.name}:\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, so)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return so


_library_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def library():
    """Build (if needed) and load the library; cached per process, built
    once under a lock when host threads ask at once."""
    with _library_lock:
        lib = ctypes.CDLL(str(build()))
    lib.rna_native_traceback_batch.argtypes = [_P] * 4 + [_I] * 4 + [_P] * 2
    lib.rna_native_traceback_batch.restype = ctypes.c_int
    lib.rna_native_probs2str.argtypes = [_P] * 3 + [_L, _P, _L]
    lib.rna_native_probs2str.restype = _L
    lib.rna_native_triple_bytes.argtypes = []
    lib.rna_native_triple_bytes.restype = _L
    return lib


def on_card(device):
    """True where ``device`` is a CUDA device (the native code runs), False
    on the CPU (the plain Python versions run); any other device raises."""
    kind = str(device).split(":")[0]
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: the port runs on cuda or cpu")
    return kind == "cuda"


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


def traceback_batch(fills, bpps, ns, gammas):
    """The centroid structures of R records x G gammas in one call: fills
    (R, G, N, N) and bpps (R, N, N) float32, ns (R,) the records' lengths,
    gammas (G,).  Returns (pairs (R, G, N // 2, 2) int32, counts (R, G)
    int32): the pairs of (r, g) are ``pairs[r, g, :counts[r, g]]``, in the
    order of ``models.centroid.traceback``."""
    fills = np.ascontiguousarray(fills, dtype=np.float32)
    bpps = np.ascontiguousarray(bpps, dtype=np.float32)
    ns = np.ascontiguousarray(ns, dtype=np.int32)
    gammas = np.ascontiguousarray(gammas, dtype=np.float32)
    R, G, N = fills.shape[0], fills.shape[1], fills.shape[-1]
    if (fills.shape != (R, G, N, N) or bpps.shape != (R, N, N)
            or ns.shape != (R,) or gammas.shape != (G,)):
        raise ValueError(
            f"traceback_batch: fills {fills.shape}, bpps {bpps.shape}, ns "
            f"{ns.shape}, gammas {gammas.shape}: expected (R, G, N, N), "
            "(R, N, N), (R,), (G,)")
    cap = max(1, N // 2)    # a base pairs at most once
    pairs = np.empty((R, G, cap, 2), np.int32)
    counts = np.empty((R, G), np.int32)
    err = library().rna_native_traceback_batch(
        _ptr(fills), _ptr(bpps), _ptr(ns), _ptr(gammas), R, G, N, cap,
        _ptr(pairs), _ptr(counts))
    if err:
        raise ValueError(
            {1: f"traceback_batch: a length in {ns.tolist()} outside "
                f"[0, {N}]",
             2: "traceback_batch: a structure with more than N // 2 pairs",
             3: "traceback_batch: out of memory"}[err])
    traceback_calls.add()
    return pairs, counts


def traceback(M, bpp, gamma, n):
    """``models.centroid.traceback`` in C, one (N, N) fill: (pairs,
    expected accuracy)."""
    M = np.asarray(M, dtype=np.float32)
    bpp = np.asarray(bpp, dtype=np.float32)
    if M.ndim != 2 or M.shape[0] != M.shape[1] or bpp.shape != M.shape:
        raise ValueError(f"traceback: fill {M.shape} and BPP {bpp.shape}, "
                         "expected two (N, N)")
    pairs, counts = traceback_batch(M[None, None], bpp[None], [n], [gamma])
    return ([(int(i), int(j)) for i, j in pairs[0, 0, :counts[0, 0]]],
            float(M[0, n - 1]))


def probs2str_arrays(iv, jv, pv):
    """``utils.output.probs2str`` in C on (row indices, column indices,
    values): the same bytes."""
    iv = np.ascontiguousarray(iv, dtype=np.int32)
    jv = np.ascontiguousarray(jv, dtype=np.int32)
    pv = np.ascontiguousarray(pv, dtype=np.float32)
    count = len(pv)
    if pv.ndim != 1 or iv.shape != (count,) or jv.shape != (count,):
        raise ValueError(f"probs2str_arrays: {iv.shape}, {jv.shape}, "
                         f"{pv.shape}: expected three (count,)")
    lib = library()
    out = np.empty(count * lib.rna_native_triple_bytes(), np.uint8)
    size = lib.rna_native_probs2str(_ptr(iv), _ptr(jv), _ptr(pv), count,
                                    _ptr(out), out.size)
    if size < 0:
        raise RuntimeError("probs2str_arrays: output buffer too small")
    return out[:size].tobytes().decode("ascii")
