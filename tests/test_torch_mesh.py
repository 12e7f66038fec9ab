"""The port's data mesh (``parallel/mesh.py``) on the CPU: the shard
layout, both engines over a mesh of three CPU entries against the engines
without one, ``initialize_distributed``'s decisions, the two-rank dry run
under gloo, and ``data_mesh()`` refusing to run without a GPU."""

import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from rna_algos_tpu_torch.constants import PSEUDO_BASE
from rna_algos_tpu_torch.parallel import mesh as mesh_lib
from rna_algos_tpu_torch.parallel.runner import AlignEngine, FoldEngine

from .conftest import REPO_ROOT
from .scan_cases import single_torch_thread  # noqa: F401  (fixture)

TOL_BPP = 1e-4      # the engines' plain-path gate
TOL_ALIGN = 1e-5    # the exact Durbin path's gate against its plain path
DRYRUN_TIMEOUT = 120


@pytest.mark.parametrize("b,k", [(0, 3), (2, 3), (7, 3), (9, 3), (5, 1),
                                 (64, 5)])
def test_shard_batch_layout(b, k):
    mesh = mesh_lib.data_mesh(["cpu"] * k)
    assert mesh.size == k and mesh.distinct_devices() == [torch.device("cpu")]
    rows = np.arange(b)
    labels = [f"r{i}" for i in range(b)]
    shards = mesh_lib.shard_batch(mesh, rows, torch.as_tensor(rows), labels)
    assert len(shards) == k
    sizes = [len(s[0]) for s in shards]
    assert sizes == [len(p) for p in np.array_split(rows, k)]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes,
                                                            reverse=True)
    assert np.concatenate([s[0] for s in shards]).tolist() == rows.tolist()
    for a, t, lab in shards:
        assert t.tolist() == a.tolist() and lab == [f"r{i}" for i in a]


def test_run_sharded_one_thread_an_entry_in_input_order():
    mesh = mesh_lib.data_mesh(["cpu"] * 4)
    barrier = threading.Barrier(4, timeout=30)

    def fn(device, part):
        barrier.wait()      # all four entries run at once
        return [(int(x), threading.get_ident(), str(device)) for x in part]

    parts = mesh_lib.run_sharded(fn, mesh, list(range(10)))
    got = [r for part in parts for r in part]
    assert [r[0] for r in got] == list(range(10))
    assert len({r[1] for r in got}) == 4
    assert {r[2] for r in got} == {"cpu"}
    # one entry: the calling thread
    one = mesh_lib.run_sharded(lambda d, p: [threading.get_ident()],
                               mesh_lib.data_mesh(["cpu"]), [0, 1])
    assert one == [[threading.get_ident()]]


def test_launch_counter_loses_no_count_across_threads():
    """A mesh's shards count launches from their own threads: many threads
    adding at once, with a short switch interval, lose no update."""
    from rna_algos_tpu_torch.ops._build import LaunchCounter

    counter, threads, adds = LaunchCounter("stress"), 16, 5000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [counter.add()
                                                    for _ in range(adds)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert counter.count == threads * adds


def _seqs(trna_records):
    """The six tRNAs (bucket 128) and two 40-nt sequences (bucket 64, fewer
    sequences than the mesh has entries)."""
    rng = np.random.default_rng(17)
    return ([r.seq for r in trna_records]
            + [rng.integers(0, 4, 40).astype(np.int64) for _ in range(2)])


@pytest.mark.usefixtures("single_torch_thread")
@pytest.mark.parametrize("contra", [True, False], ids=["contra", "turner"])
def test_fold_engine_on_a_cpu_mesh_equals_no_mesh(trna_records, contra):
    seqs = _seqs(trna_records)
    mesh = mesh_lib.data_mesh(["cpu"] * 3)
    engine = FoldEngine(uses_contra_model=contra, mesh=mesh)
    assert engine.mesh is mesh and list(engine.tables) == [
        torch.device("cpu")]
    want = FoldEngine(uses_contra_model=contra, device="cpu").fold_batch(seqs)
    got = engine.fold_batch(seqs)
    assert len(got) == len(seqs)
    for s, (wb, wp), (gb, gp) in zip(seqs, want, got):
        assert gb.shape == (len(s), len(s))
        assert (gp == wp).all()
        assert float(np.abs(gb - wb).max()) <= TOL_BPP


@pytest.mark.usefixtures("single_torch_thread")
def test_align_engine_on_a_cpu_mesh_equals_no_mesh(trna_records):
    seqs = [np.concatenate([[PSEUDO_BASE], s, [PSEUDO_BASE]])
            for s in _seqs(trna_records)]
    pairs = [(0, 1), (2, 3), (4, 5), (1, 0), (6, 7), (3, 0), (5, 2)]
    mesh = mesh_lib.data_mesh(["cpu"] * 3)
    want = AlignEngine(device="cpu").match_probs_pairs(seqs, pairs)
    got = AlignEngine(mesh=mesh).match_probs_pairs(seqs, pairs)
    assert list(got) == list(want) == pairs
    for key, w in want.items():
        assert got[key].shape == w.shape
        assert float(np.abs(got[key] - w).max()) <= TOL_ALIGN, key


def test_pad_to_multiple_equals_jax():
    from rna_algos_tpu.parallel import mesh as jax_mesh

    rows = (np.arange(14, dtype=np.int32).reshape(7, 2),
            np.arange(7, dtype=np.int32))
    pads = (np.full((2,), 4, np.int32), np.int32(1))
    for multiple in (1, 3, 7, 8):
        (got, b), (want, b2) = (mod.pad_to_multiple(rows, multiple, pads)
                                for mod in (mesh_lib, jax_mesh))
        assert b == b2 == 7
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


PROBE = r"""
import json, os
import torch.distributed as dist
from rna_algos_tpu_torch.parallel import mesh
started = mesh.initialize_distributed()
print(json.dumps({"started": started, "initialized": dist.is_initialized(),
                  "backend": dist.get_backend() if started else None}))
if started:
    dist.destroy_process_group()
"""

CLEAN = {k: v for k, v in os.environ.items()
         if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                      "LOCAL_RANK", "RNA_ALGOS_DISTRIBUTED")}


def _probe(**env):
    import json

    res = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=str(REPO_ROOT),
        env={**CLEAN, **env}, capture_output=True, text=True, timeout=60,
    )
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_initialize_distributed_decisions():
    """No launcher variables: a no-op.  WORLD_SIZE=1 without the opt-in:
    declined.  With RNA_ALGOS_DISTRIBUTED=1 a one-rank group starts, on
    gloo where there is no GPU."""
    off = {"started": False, "initialized": False, "backend": None}
    assert _probe() == off
    one = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT":
           str(mesh_lib._free_port()), "WORLD_SIZE": "1", "RANK": "0"}
    assert _probe(**one) == off
    got = _probe(**one, RNA_ALGOS_DISTRIBUTED="1")
    assert got["started"] and got["initialized"]
    assert got["backend"] == ("nccl" if torch.cuda.is_available()
                              else "gloo")


def test_dryrun_multidevice_two_ranks_gloo():
    """The dry run in a subprocess of its own session, killed whole (its
    ranks too) if it outlasts DRYRUN_TIMEOUT."""
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "from rna_algos_tpu_torch.parallel.mesh import dryrun_multidevice;"
         " dryrun_multidevice(2)"],
        cwd=str(REPO_ROOT), env={**CLEAN, "OMP_NUM_THREADS": "2"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True,
    )
    try:
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-4000:]
    ok = [line for line in out.splitlines() if line.startswith("OK")]
    assert len(ok) == 1 and "2 ranks, backend gloo" in ok[0], out


def test_data_mesh_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("needs a host with no GPU")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        mesh_lib.data_mesh()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        mesh_lib.data_mesh(["cpu", "cuda:0"])
    for engine in (FoldEngine, AlignEngine):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            engine(device="cuda")
