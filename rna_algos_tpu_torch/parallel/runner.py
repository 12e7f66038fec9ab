"""Batch execution: length buckets and padded device batches
(``rna_algos_tpu.parallel.runner``), both folding models and the Durbin
pair-HMM, without a mesh."""

import warnings

import numpy as np
import torch

from ..constants import PSEUDO_BASE
from ..numerics import check_mode
from ..params import build_align_scores, build_fold_score_sets

from ..models import durbin as D
from ..models import mccaskill as M
from ..ops import pallas_align as PA
from ..weights import align_tables, contra_tables, turner_tables

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


def resolve_device(device):
    """torch.device for ``device``; a CUDA device with no GPU raises (the
    port never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA GPU is available"
        )
    return device


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


class AlignEngine:
    """Bucketed Durbin pair-HMM batch runner on one device."""

    def __init__(self, align_scores=None, device="cuda", numerics="exact"):
        self.device = resolve_device(device)
        self.numerics = check_mode(numerics)
        sc = build_align_scores() if align_scores is None else align_scores
        self.at = align_tables(sc, self.device)

    def match_probs_pairs(self, seqs, pairs):
        """Posterior match probabilities for (a, b) index pairs of
        sentinel-wrapped sequences (bin/durbin_algo.rs:49-50), as the JAX
        engine returns them: ``{(a, b): probs}``, each a numpy array cropped
        to (len(seqs[a]), len(seqs[b])), keyed in the order of ``pairs``
        (pairs are batched by bucket)."""
        results = dict.fromkeys(map(tuple, pairs))
        by_bucket = {}
        for k, (a, b) in enumerate(pairs):
            key = align_bucket(len(seqs[a]), len(seqs[b]))
            by_bucket.setdefault(key, []).append(k)

        def dev(x):
            return torch.as_tensor(x, dtype=torch.int32, device=self.device)

        for (N1, N2), ks in by_bucket.items():
            firsts = [seqs[pairs[k][0]] for k in ks]
            seconds = [seqs[pairs[k][1]] for k in ks]
            probs = D.durbin_match_probs_batch_auto(
                dev(pad_seqs(firsts, N1)), dev([len(s) for s in firsts]),
                dev(pad_seqs(seconds, N2)), dev([len(s) for s in seconds]),
                self.at, N1=N1, N2=N2, numerics=self.numerics,
            ).cpu().numpy()
            for slot, k in enumerate(ks):
                results[tuple(pairs[k])] = probs[slot, :len(firsts[slot]),
                                                 :len(seconds[slot])]
        return results


class FoldEngine:
    """Cached-table, bucketed McCaskill batch runner on one device."""

    def __init__(self, uses_contra_model=False, allows_short_hairpins=False,
                 fss=None, device="cuda", numerics="exact"):
        """``fss``: the CONTRAfold score-set dict the tables are built from
        (``build_fold_score_sets()`` when None); the Turner model ignores
        it, as the JAX engine does."""
        self.contra = bool(uses_contra_model)
        self.allows_short_hairpins = bool(allows_short_hairpins)
        self.device = resolve_device(device)
        self.numerics = check_mode(numerics)
        if self.contra:
            self.tbl = contra_tables(
                build_fold_score_sets() if fss is None else fss, self.device)
        else:
            self.tbl = turner_tables(self.device)

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
            arr = torch.as_tensor(pad_seqs([seqs[k] for k in idxs], N),
                                  dtype=torch.int64, device=self.device)
            ns = torch.as_tensor([len(seqs[k]) for k in idxs],
                                 dtype=torch.int32, device=self.device)
            bpp, presence = M.mccaskill_bpp_batch_auto(
                arr, ns, self.tbl, N=N, contra=self.contra,
                allows_short_hairpins=self.allows_short_hairpins,
                numerics=self.numerics,
            )
            bpp = bpp.cpu().numpy()
            presence = presence.cpu().numpy()
            for slot, k in enumerate(idxs):
                n = len(seqs[k])
                results[k] = (bpp[slot, :n, :n], presence[slot, :n, :n])
        return results
