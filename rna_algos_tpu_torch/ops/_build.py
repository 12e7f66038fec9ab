"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

One shared library with a plain C interface, compiled by ``nvcc`` for
``sm_90a`` at first use and loaded with ``ctypes``: one ``nvcc -c`` per
source, all started together, then one link.  The library's name carries a
hash of the sources, so an edit rebuilds and a stale build is never
loaded.  It lives in ``rna_algos_tpu_torch/_build/`` (git-ignored).
Nothing here runs at import time.
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
import time

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types.  Every pointer (and the stream)
# is a c_void_p so ctypes never narrows it to a 32-bit int.
SIGNATURES = {
    "rna_skew": [ctypes.POINTER(_P), ctypes.POINTER(_P), _I, _I, _I, _I, _P],
    "rna_contra_inside": [_P] * 17 + [_I, _I, _P],
    "rna_contra_outside": [_P] * 20 + [_I, _I, _I, _P],
    "rna_contra_inside_cluster": [_I, _I],
    "rna_contra_outside_cluster": [_I, _I],
    "rna_contra_inside_threads": [_I, _I],
    "rna_contra_outside_threads": [_I, _I],
    "rna_turner_inside": [ctypes.POINTER(_P)] + [_P] * 8 + [_I, _I, _P],
    "rna_turner_outside": [ctypes.POINTER(_P)] + [_P] * 10 + [_I, _I, _I, _P],
    "rna_turner_inside_cluster": [_I, _I],
    "rna_turner_outside_cluster": [_I, _I],
    "rna_turner_inside_threads": [_I, _I],
    "rna_turner_outside_threads": [_I, _I],
    "rna_pairhmm_prob": [_P] * 9 + [_I, _I, _I, _P],
    "rna_pairhmm_log": [_P] * 9 + [_I, _I, _I, _P],
    "rna_pairhmm_log_fast": [_P] * 9 + [_I, _I, _I, _P],
    "rna_pairhmm_rows": [_P] * 10 + [_I] * 5 + [_P],
    "rna_pairhmm_rows_plan": [_I, _I, ctypes.POINTER(_I)],
    "rna_contra_inside_log": [ctypes.POINTER(_P)] + [_P] * 8 + [_I, _I, _P],
    "rna_contra_outside_log": [ctypes.POINTER(_P)] + [_P] * 12
    + [_I, _I, _I, _P],
    "rna_turner_inside_log": [ctypes.POINTER(_P)] + [_P] * 9 + [_I, _I, _P],
    "rna_turner_outside_log": [ctypes.POINTER(_P)] + [_P] * 12
    + [_I, _I, _I, _P],
    "rna_log_group_of": [_I],
    "rna_scan_blocks": [_I, _I, _I, _P],
    "rna_scan_pass": [_I, ctypes.POINTER(_P), _P, ctypes.POINTER(_P),
                      ctypes.POINTER(_P)] + [_P] * 5 + [_I] * 7 + [_P],
    "rna_mea_fill": [_P] * 4 + [_I] * 6 + [_P],
    "rna_mea_fill_plan": [_I, _I, _I, ctypes.POINTER(_I)],
}


def sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash():
    h = hashlib.sha256()
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


class LaunchCounter:
    """Launches of one kernel: its wrapper adds one where it launches the
    kernel and nowhere else; a run resets the count before and reads it
    after.  ``add`` holds a lock, since a mesh's shards launch from a host
    thread each."""

    def __init__(self, name):
        self.name = name
        self.count = 0
        self._lock = threading.Lock()

    def add(self):
        with self._lock:
            self.count += 1

    def reset(self):
        self.count = 0


class KernelLibrary:
    """The loaded library plus what its build reported."""

    def __init__(self, lib, path, build_seconds, compiler_output):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds
        self.compiler_output = compiler_output

    def call(self, name, *args):
        """Call a C entry point; raise if it reports a CUDA error."""
        err = getattr(self.lib, name)(*args)
        if err != 0:
            msg = self.lib.rna_error_string(err).decode()
            raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: nvcc is needed to build "
                           "the rna_algos_tpu_torch kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


_library_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def library():
    """Build (if needed) and load the kernel library; cached per process.
    Host threads that call it at once build it once: the build runs under a
    lock, and a later caller finds the library built."""
    with _library_lock:
        return _load_library()


def _load_library():
    BUILD_DIR.mkdir(exist_ok=True)
    so = BUILD_DIR / f"librna_kernels_{source_hash()}.so"
    log = so.with_suffix(".log")    # the compiler's output of that build
    build_seconds, out = 0.0, log.read_text() if log.exists() else ""
    if not so.exists():
        t0 = time.perf_counter()
        work = pathlib.Path(tempfile.mkdtemp(dir=BUILD_DIR))
        cu = sorted(CSRC_DIR.glob("*.cu"))
        objs = [work / (p.stem + ".o") for p in cu]
        procs = [
            subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o",
                 str(o), str(p)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for p, o in zip(cu, objs)
        ]
        outs = [p.communicate()[0] for p in procs]
        out = "".join(
            f"== {src.name}\n{o}" for src, o in zip(cu, outs)
        )
        failed = [src.name for src, p in zip(cu, procs) if p.returncode]
        tmp = work / "lib.so"
        if not failed:
            res = subprocess.run(
                [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True,
            )
            out += res.stdout + res.stderr
            if res.returncode:
                failed = ["link"]
        if failed:
            shutil.rmtree(work, ignore_errors=True)
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{out}")
        log.write_text(out)
        os.replace(tmp, so)
        shutil.rmtree(work, ignore_errors=True)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.rna_error_string.argtypes = [ctypes.c_int]
    lib.rna_error_string.restype = ctypes.c_char_p
    return KernelLibrary(lib, so, build_seconds, out)


def stream_ptr(device):
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def ptr_array(tables, names):
    """A C array of the data pointers of ``tables[k]`` for k in ``names``
    (the table arguments of the Turner and log-space entry points)."""
    return (_P * len(names))(*[tables[k].data_ptr() for k in names])


def check_cuda(name, tensors, shapes, device, ints=("ns",)):
    """Validate what a kernel takes: device, float32 (int32 for the keys in
    ``ints``), shape, layout."""
    import torch

    for key, t in tensors.items():
        want = shapes[key]
        if t.device != device:
            raise ValueError(f"{name}: {key} on {t.device}, expected {device}")
        dt = torch.int32 if key in ints else torch.float32
        if t.dtype != dt:
            raise ValueError(f"{name}: {key} is {t.dtype}, expected {dt}")
        if tuple(t.shape) != tuple(want):
            raise ValueError(
                f"{name}: {key} has shape {tuple(t.shape)}, expected {want}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
