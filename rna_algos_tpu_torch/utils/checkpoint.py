"""BPP checkpoint / resume.

The expensive artifact of the pipeline is the partition-function BPP matrix;
the reference recomputes it per run and only reuses it in-memory across the
gamma grid (bin/centroid_fold.rs:117-132,146).  Here BPPs persist to an .npz
store keyed by (sequence, model, flags), so the centroid/gamma stage — and a
re-run after a failure — resumes without re-running the inside/outside DP
(failure detection / checkpoint-resume; SURVEY §5).
"""

import hashlib
import os

import numpy as np


def fold_key(seq, uses_contra_model, allows_short_hairpins=False):
    h = hashlib.sha256()
    h.update(np.asarray(seq, dtype=np.int32).tobytes())
    h.update(bytes([int(uses_contra_model), int(allows_short_hairpins)]))
    return h.hexdigest()[:32]


class BppStore:
    """One .npz file per sequence, content-addressed."""

    def __init__(self, root):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key):
        return os.path.join(self.root, f"{key}.npz")

    def get(self, key):
        path = self._path(key)
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            return z["bpp"], z["presence"]

    def put(self, key, bpp, presence):
        # Write to an explicit .tmp.npz (np.savez appends .npz only to names
        # without one, so this name is used verbatim) and atomically replace.
        path = self._path(key)
        tmp = path + ".tmp.npz"
        with open(tmp, "wb") as f:
            np.savez_compressed(
                f, bpp=np.asarray(bpp), presence=np.asarray(presence)
            )
        os.replace(tmp, path)


def cached_fold_batch(engine, seqs, store):
    """FoldEngine.fold_batch with checkpoint/resume through a BppStore.

    Completed sequences are loaded; only the missing ones hit the device.
    """
    keys = [
        fold_key(s, engine.contra, engine.allows_short_hairpins) for s in seqs
    ]
    results = [store.get(k) for k in keys]
    missing = [i for i, r in enumerate(results) if r is None]
    if missing:
        fresh = engine.fold_batch([seqs[i] for i in missing])
        for i, res in zip(missing, fresh):
            store.put(keys[i], *res)
            results[i] = res
    return results
