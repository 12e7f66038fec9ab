"""Data-mesh parallelism for batch folding and aligning
(``rna_algos_tpu.parallel.mesh``).

A 1-D ``data`` mesh is a list of devices, one entry a shard.  A batch is
split along axis 0 into contiguous shards, one for each entry; every entry
runs the same path (tier and kernels) on its shard with its own copy of the
score tables, and the only collective is the gather of the results on the
host, in input order.  An entry may repeat a device, so one card, or the
CPU, can be split into shards.

Each entry runs on a host thread of its own: the rescale-retry loops sync
the device once per iteration, so shards launched from one thread would run
one after another.  Entries that share a device share its current stream,
and so run on it in turn; entries on distinct devices run at once.

Multi-process: ``initialize_distributed()`` starts a ``torch.distributed``
process group when a launcher's variables are set.  Each rank then runs its own
contiguous slice of a batch over its local mesh, and ``run_sharded`` gathers
the slices with ``all_gather_object``.
"""

import os
import socket
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..utils.platform import on_cuda, resolve_device


def initialize_distributed(backend=None):
    """Start the ``torch.distributed`` process group under a multi-process
    launcher; returns whether it did.

    Decided from environment variables only: torchrun's ``MASTER_ADDR``,
    ``WORLD_SIZE`` and ``RANK``, or an explicit ``RNA_ALGOS_DISTRIBUTED=1``
    (which then needs ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK`` as well).  A no-op returning False with no launcher variables, or
    with ``WORLD_SIZE=1`` and no explicit opt-in.  ``backend`` None fits
    the local devices: ``nccl`` where a GPU is present (each rank on
    ``LOCAL_RANK``'s card, else ``RANK``'s), ``gloo`` on the CPU; "gloo"
    keeps the ranks on the CPU where a GPU is present."""
    explicit = os.environ.get("RNA_ALGOS_DISTRIBUTED") == "1"
    launched = all(k in os.environ for k in ("MASTER_ADDR", "WORLD_SIZE",
                                             "RANK"))
    if not launched and not explicit:
        return False
    world = os.environ.get("WORLD_SIZE")
    if world is not None and int(world) <= 1 and not explicit:
        return False
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        rank = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        torch.cuda.set_device(rank % torch.cuda.device_count())
    elif backend != "gloo":
        raise ValueError(f"initialize_distributed: backend {backend!r}")
    dist.init_process_group(backend=backend, init_method="env://")
    return True


def _distributed():
    """(rank, world size) of an initialized process group of more than one
    rank, else None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if world > 1:
            return dist.get_rank(), world
    return None


class DataMesh:
    """A 1-D mesh: ``devices``, one ``torch.device`` an entry, in order."""

    def __init__(self, devices):
        self.devices = tuple(_entry(d) for d in devices)
        if not self.devices:
            raise ValueError("a data mesh needs at least one device")

    @property
    def size(self):
        return len(self.devices)

    def distinct_devices(self):
        """The mesh's devices without repeats, in order of first entry."""
        return list(dict.fromkeys(self.devices))

    def __repr__(self):
        return f"DataMesh({[str(d) for d in self.devices]})"


def _entry(device):
    """A mesh entry: the device, checked (a CUDA device with no GPU raises),
    a bare ``cuda`` pinned to the current card."""
    device = resolve_device(device)
    if on_cuda(device) and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def data_mesh(devices=None):
    """1-D mesh over every CUDA device, or over ``devices`` (a device may
    repeat).  With no GPU and no list given it raises: there is no fallback
    to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "data_mesh(): no CUDA GPU available; pass a device list "
                "(e.g. ['cpu'] * 2) to shard on the CPU")
        devices = [torch.device("cuda", k)
                   for k in range(torch.cuda.device_count())]
    return DataMesh(devices)


def shard_bounds(b, k):
    """Contiguous [lo, hi) bounds of k shards of b rows: sizes differ by at
    most one, the larger first (``np.array_split``'s rule)."""
    base, extra = divmod(b, k)
    bounds, lo = [], 0
    for s in range(k):
        hi = lo + base + (s < extra)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def shard_batch(mesh, *arrays):
    """Split axis 0 of each array (tensors, numpy arrays or lists) into
    contiguous shards, one for each mesh entry: a list of tuples, entry s
    holding each array's rows of shard s.  A shard may be empty."""
    b = len(arrays[0])
    return [tuple(a[lo:hi] for a in arrays)
            for lo, hi in shard_bounds(b, mesh.size)]


def _run_local(fn, mesh, arrays):
    """``fn(device, *shard)`` for each non-empty shard of ``arrays`` over the
    mesh's entries, one host thread an entry; results in shard order."""
    jobs = [(dev, shard) for dev, shard in zip(mesh.devices,
                                               shard_batch(mesh, *arrays))
            if len(shard[0])]
    if len(jobs) <= 1:
        return [_on_device(fn, dev, shard) for dev, shard in jobs]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = [pool.submit(_on_device, fn, dev, shard)
                   for dev, shard in jobs]
        return [f.result() for f in futures]


def _on_device(fn, device, shard):
    if on_cuda(device):
        with torch.cuda.device(device):
            return fn(device, *shard)
    return fn(device, *shard)


def run_sharded(fn, mesh, *arrays):
    """Run ``fn(device, *shard)`` on each mesh entry's contiguous shard of
    ``arrays`` and return the shards' results in input order (a list, one
    item a non-empty shard).

    Under an initialized process group of more than one rank, each rank
    takes its own contiguous slice of the batch, runs it over its local
    mesh, and the ranks' results are gathered with ``all_gather_object``
    (the only collective), so every rank returns the whole batch's."""
    dist_info = _distributed()
    if dist_info is None:
        return _run_local(fn, mesh, arrays)
    import torch.distributed as dist

    rank, world = dist_info
    lo, hi = shard_bounds(len(arrays[0]), world)[rank]
    mine = _run_local(fn, mesh, tuple(a[lo:hi] for a in arrays))
    gathered = [None] * world
    dist.all_gather_object(gathered, mine)
    return [r for part in gathered for r in part]


def pad_to_multiple(arrays, multiple, pad_rows):
    """Pad axis 0 of each array to a multiple (dummy rows from ``pad_rows``)."""
    b = arrays[0].shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return arrays, b
    out = []
    for a, pad_row in zip(arrays, pad_rows):
        pad = np.broadcast_to(pad_row, (rem,) + a.shape[1:])
        out.append(np.concatenate([a, pad], axis=0))
    return tuple(out), b


# The multi-device dry run


def _free_port():
    """A free TCP port on 127.0.0.1 (bound, read, released)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dryrun_inputs():
    """The dry run's batches: the six tRNAs tiled to 12 for both models,
    and the Durbin pairs of six of them (sentinel-wrapped)."""
    import pathlib

    from ..constants import PSEUDO_BASE
    from ..utils.io import read_fasta

    fasta = (pathlib.Path(__file__).resolve().parents[2] / "assets"
             / "sampled_trnas.fa")
    trnas = [r.seq for r in read_fasta(fasta)]
    seqs = trnas * 2
    wrapped = [np.concatenate([[PSEUDO_BASE], s, [PSEUDO_BASE]]).astype(
        np.int64) for s in trnas]
    pairs = [(a, b) for a in range(len(wrapped))
             for b in range(a + 1, len(wrapped))]
    return seqs, wrapped, pairs


def _dryrun_work(device, mesh):
    """Both fold models, the 18-gamma centroid grid and the Durbin pairs,
    over ``mesh`` (or without one when ``mesh`` is None)."""
    from ..models.centroid import DEFAULT_GAMMAS, centroid_structures
    from .runner import AlignEngine, FoldEngine

    seqs, wrapped, pairs = _dryrun_inputs()
    kw = {"mesh": mesh} if mesh is not None else {"device": device}
    out = {}
    for model in ("contra", "turner"):
        folded = FoldEngine(uses_contra_model=model == "contra",
                            **kw).fold_batch(seqs)
        out[model] = folded
        results = [(b, p, len(s)) for (b, p), s in zip(folded, seqs)]
        if mesh is None:
            parts = [centroid_structures(results, DEFAULT_GAMMAS, device)]
        else:
            parts = run_sharded(
                lambda dev, part: centroid_structures(part, DEFAULT_GAMMAS,
                                                      dev),
                mesh, results)
        out[f"{model}_centroid"] = {
            g: [s for part in parts for s in part[g]] for g in DEFAULT_GAMMAS}
    out["durbin"] = AlignEngine(**kw).match_probs_pairs(wrapped, pairs)
    return out


def _dryrun_compare(want, got):
    """Largest |difference| between the unsharded and gathered results
    (BPPs, match probabilities), and whether presence and the centroid
    structures are identical."""
    worst, same = 0.0, True
    for model in ("contra", "turner"):
        for (wb, wp), (gb, gp) in zip(want[model], got[model]):
            worst = max(worst, float(np.abs(wb - gb).max()))
            same &= bool((wp == gp).all())
        same &= want[f"{model}_centroid"] == got[f"{model}_centroid"]
    same &= list(want["durbin"]) == list(got["durbin"])
    for key, probs in want["durbin"].items():
        worst = max(worst, float(np.abs(probs - got["durbin"][key]).max()))
    return worst, same


DRYRUN_TOL = 1e-4   # the plain-path gate of the engines' BPPs


def _dryrun_rank(rank, world, port, device):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    import torch.distributed as dist

    backend = "gloo" if device == "cpu" else "nccl"
    if not initialize_distributed(backend):
        raise RuntimeError("dry run: the process group did not start")
    local = torch.device("cpu") if device == "cpu" else torch.device(
        "cuda", rank)
    try:
        got = _dryrun_work(local, data_mesh([local]))
        if rank == 0:
            want = _dryrun_work(local, None)
            worst, same = _dryrun_compare(want, got)
            if not (same and worst <= DRYRUN_TOL):
                raise AssertionError(
                    f"dry run: {world} ranks differ from the unsharded run "
                    f"(max |d| {worst:.3e}, identical structures {same})")
            print(f"OK dryrun_multidevice: {world} ranks, backend "
                  f"{dist.get_backend()}, {len(got['contra'])} sequences a "
                  f"model, 18 gammas, {len(got['durbin'])} Durbin pairs; max "
                  f"|d| vs unsharded {worst:.3e}", flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dryrun_multidevice(n_devices, device="cpu"):
    """Spawn ``n_devices`` ranks on 127.0.0.1 (gloo on the CPU, NCCL with
    one GPU a rank), each folding its slice of a CONTRA and a Turner tRNA
    batch, running its slice of the 18-gamma centroid grid and aligning
    its slice of Durbin pairs; rank 0 holds the gathered results against
    the unsharded run and prints one ``OK`` line.  Raises if a rank
    fails."""
    import torch.multiprocessing as mp

    device = torch.device(device).type
    if device == "cuda":
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(
                f"dryrun_multidevice: {n_devices} ranks need as many GPUs, "
                f"{torch.cuda.device_count()} present")
    elif device != "cpu":
        raise ValueError(f"dryrun_multidevice: no backend for {device}")
    mp.spawn(_dryrun_rank, args=(n_devices, _free_port(), device),
             nprocs=n_devices, join=True)

