"""Batch execution: length buckets and padded device batches
(``rna_algos_tpu.parallel.runner``), both folding models and the Durbin
pair-HMM, on one device or over a data mesh (``parallel/mesh.py``)."""

import warnings

import numpy as np
import torch

from ..constants import PSEUDO_BASE
from ..numerics import check_mode
from ..params import build_align_scores, build_fold_score_sets

from ..models import durbin as D
from ..models import mccaskill as M
from ..ops import pallas_align as PA
from ..utils import debug
from ..utils.platform import resolve_device
from ..weights import align_tables, contra_tables, turner_tables
from . import mesh as mesh_lib

# Static length buckets (as in the JAX package).
BUCKETS = (64, 96, 128, 192, 256, 384, 512)


def pick_bucket(n):
    for b in BUCKETS:
        if n <= b:
            return b
    if n > 2048:
        # past the last kernel tier only the generic-N scan folds it
        warnings.warn(
            f"sequence length {n} exceeds the fused-kernel tiers "
            "(N <= 2048); it folds through the generic-N scan (K20/K21)",
            RuntimeWarning,
            stacklevel=2,
        )
    return ((n + 127) // 128) * 128


# The JAX runner's promotions to the power-of-two tiers of every mode.
POW2_BUCKET = {96: 128, 192: 256}


def kernel_bucket(n, contra, numerics="exact"):
    """The bucket the port folds a length-n sequence in, the JAX runner's
    rule: ``pick_bucket``, promoted to a power-of-two kernel tier only
    where that tier takes it (96 -> 128, 192 -> 256; in the probability
    tiers 384 -> 512, (512, 1024] -> 1024 and, for CONTRA, (1024, 2048] ->
    2048).  Every other bucket (384 and up under parity, Turner past 1024,
    any model past 2048) stays a multiple of 128 and runs the generic-N
    scan."""
    N = pick_bucket(n)
    if N in POW2_BUCKET:
        return POW2_BUCKET[N]
    for lo, hi in ((256, 512), (512, 1024), (1024, 2048)):
        if lo < N <= hi and M.pallas_available(contra, hi, numerics):
            return hi
    return N


def pad_seqs(seqs, N):
    out = np.full((len(seqs), N), PSEUDO_BASE, dtype=np.int32)
    for k, s in enumerate(seqs):
        out[k, : len(s)] = s
    return out


def align_bucket(n1, n2):
    """The (N1, N2) bucket the port aligns a pair of wrapped lengths
    (n1, n2) in, the JAX runner's rules: where the least power of two
    >= 64 covering the larger ``pick_bucket`` is a wavefront bucket
    (K14/K15, <= 256), that square; otherwise (pick_bucket(n1),
    pick_bucket(n2)), the key the JAX runner gives its row scan, which
    the row scan K22 takes at any shape."""
    n = max(pick_bucket(n1), pick_bucket(n2))
    N = 64
    while N < n:
        N *= 2
    if PA.pallas_available(N, N):
        return N, N
    return pick_bucket(n1), pick_bucket(n2)


def _devices(device, mesh):
    """(the engine's device, the devices that hold a table set): without a
    mesh ``device``; with one its first entry and its distinct devices."""
    if mesh is None:
        device = resolve_device(device)
        return device, [device]
    return mesh.devices[0], mesh.distinct_devices()


def _run(fn, mesh, device, *arrays):
    """``fn(device, *arrays)`` as one shard's results, or each mesh entry's
    contiguous shard of ``arrays`` (``mesh_lib.run_sharded``), the shards'
    results concatenated in input order."""
    if mesh is None:
        return fn(device, *arrays)
    return [r for part in mesh_lib.run_sharded(fn, mesh, *arrays)
            for r in part]


class AlignEngine:
    """Bucketed Durbin pair-HMM batch runner on one device or over a data
    mesh."""

    def __init__(self, align_scores=None, device="cuda", numerics="exact",
                 mesh=None):
        """``mesh``: a ``parallel.mesh.data_mesh``; each bucket's pairs are
        then split over its entries (``device`` is ignored), one align-table
        set a distinct device of the mesh."""
        debug.maybe_enable_from_env()
        self.mesh = mesh
        self.device, devices = _devices(device, mesh)
        self.numerics = check_mode(numerics)
        sc = build_align_scores() if align_scores is None else align_scores
        self.tables = {dev: align_tables(sc, dev) for dev in devices}
        self.at = self.tables[self.device]

    def _align(self, device, N1, N2, firsts, seconds):
        """One shard of a bucket on ``device``: the cropped probabilities of
        each pair, in order."""
        def dev(x):
            return torch.as_tensor(x, dtype=torch.int32, device=device)

        probs = D.durbin_match_probs_batch_auto(
            dev(pad_seqs(firsts, N1)), dev([len(s) for s in firsts]),
            dev(pad_seqs(seconds, N2)), dev([len(s) for s in seconds]),
            self.tables[device], N1=N1, N2=N2, numerics=self.numerics,
        ).cpu().numpy()
        return [probs[slot, :len(a), :len(b)]
                for slot, (a, b) in enumerate(zip(firsts, seconds))]

    def match_probs_pairs(self, seqs, pairs):
        """Posterior match probabilities for (a, b) index pairs of
        sentinel-wrapped sequences (bin/durbin_algo.rs:49-50), as the JAX
        engine returns them: ``{(a, b): probs}``, each a numpy array cropped
        to (len(seqs[a]), len(seqs[b])), keyed in the order of ``pairs``
        (pairs are batched by bucket; with a mesh, a bucket's pairs are
        split over its entries)."""
        results = dict.fromkeys(map(tuple, pairs))
        by_bucket = {}
        for k, (a, b) in enumerate(pairs):
            key = align_bucket(len(seqs[a]), len(seqs[b]))
            by_bucket.setdefault(key, []).append(k)
        for (N1, N2), ks in by_bucket.items():
            firsts = [seqs[pairs[k][0]] for k in ks]
            seconds = [seqs[pairs[k][1]] for k in ks]
            probs = _run(lambda dev, f, s: self._align(dev, N1, N2, f, s),
                         self.mesh, self.device, firsts, seconds)
            for k, p in zip(ks, probs):
                results[tuple(pairs[k])] = p
        if debug.nan_checks_enabled():
            debug.check_finite_states(results, "match_probs_pairs")
        return results


class FoldEngine:
    """Cached-table, bucketed McCaskill batch runner on one device or over a
    data mesh."""

    def __init__(self, uses_contra_model=False, allows_short_hairpins=False,
                 fss=None, device="cuda", numerics="exact", mesh=None):
        """``fss``: the CONTRAfold score-set dict the tables are built from
        (``build_fold_score_sets()`` when None); the Turner model ignores
        it, as the JAX engine does.  ``mesh``: a ``parallel.mesh.data_mesh``;
        each bucket's batch is then split over its entries (``device`` is
        ignored), one table set a distinct device of the mesh."""
        debug.maybe_enable_from_env()
        self.contra = bool(uses_contra_model)
        self.allows_short_hairpins = bool(allows_short_hairpins)
        self.mesh = mesh
        self.device, devices = _devices(device, mesh)
        self.numerics = check_mode(numerics)
        if self.contra:
            fss = build_fold_score_sets() if fss is None else fss
            self.tables = {dev: contra_tables(fss, dev) for dev in devices}
        else:
            self.tables = {dev: turner_tables(dev) for dev in devices}
        self.tbl = self.tables[self.device]

    def _fold(self, device, N, seqs):
        """One shard of a bucket on ``device``: (bpp, presence) of each
        sequence, cropped, in order."""
        arr = torch.as_tensor(pad_seqs(seqs, N), dtype=torch.int64,
                              device=device)
        ns = torch.as_tensor([len(s) for s in seqs], dtype=torch.int32,
                             device=device)
        bpp, presence = M.mccaskill_bpp_batch_auto(
            arr, ns, self.tables[device], N=N, contra=self.contra,
            allows_short_hairpins=self.allows_short_hairpins,
            numerics=self.numerics,
        )
        bpp = bpp.cpu().numpy()
        presence = presence.cpu().numpy()
        return [(bpp[slot, :len(s), :len(s)], presence[slot, :len(s), :len(s)])
                for slot, s in enumerate(seqs)]

    def fold_batch(self, seqs):
        """BPPs for a list of int sequences: a list of (bpp, presence)
        numpy arrays cropped to each true length, in input order."""
        order = sorted(range(len(seqs)), key=lambda k: len(seqs[k]))
        results = [None] * len(seqs)
        by_bucket = {}
        for k in order:
            by_bucket.setdefault(
                kernel_bucket(len(seqs[k]), self.contra, self.numerics),
                []).append(k)
        for N, idxs in by_bucket.items():
            folded = _run(lambda dev, part: self._fold(dev, N, part),
                          self.mesh, self.device, [seqs[k] for k in idxs])
            for k, r in zip(idxs, folded):
                results[k] = r
            if debug.nan_checks_enabled():
                debug.check_finite_states(
                    {"bpp": {k: results[k][0] for k in idxs}},
                    f"fold_batch(N={N})")
        return results
