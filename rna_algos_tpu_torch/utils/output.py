"""Output formatting: dot-bracket strings and sparse probability text.

Mirrors the reference CLI output layer: `get_fold_str` (bin/centroid_fold.rs:197-207)
and `probs2str` (bin/mccaskill_algo.rs:103-113).
"""

from ..constants import UNPAIR, BASEPAIR_LEFT, BASEPAIR_RIGHT


def fold_str(basepairs, seq_len: int) -> str:
    """Dot-bracket string from (i, j) pairs (bin/centroid_fold.rs:197-207)."""
    chars = [UNPAIR] * seq_len
    for i, j in basepairs:
        chars[int(i)] = BASEPAIR_LEFT
        chars[int(j)] = BASEPAIR_RIGHT
    return "".join(chars)


def fold_strs(pairs, counts, ns, N):
    """``fold_str`` of every structure of ``_native.traceback_batch``'s
    output (pairs (R, G, cap, 2), counts (R, G)) for records of lengths
    ``ns`` in bucket N: a list a record of G strings."""
    import numpy as np

    R, G, cap, _ = pairs.shape
    chars = np.full((R, G, N), ord(UNPAIR), np.uint8)
    r, g, k = np.nonzero(np.arange(cap) < counts[..., None])
    chars[r, g, pairs[r, g, k, 0]] = ord(BASEPAIR_LEFT)
    chars[r, g, pairs[r, g, k, 1]] = ord(BASEPAIR_RIGHT)
    return [[chars[r, g, :n].tobytes().decode("ascii") for g in range(G)]
            for r, n in enumerate(ns)]


def pairs_from_fold_str(s: str):
    """Inverse of fold_str (used by the eval stats module)."""
    stack = []
    pairs = []
    for i, ch in enumerate(s):
        if ch == BASEPAIR_LEFT:
            stack.append(i)
        elif ch == BASEPAIR_RIGHT:
            pairs.append((stack.pop(), i))
    return pairs


def probs2str_arrays(iv, jv, pv, device="cpu") -> str:
    """Vector form of probs2str (row indices, column indices, values): for
    a CUDA ``device`` (the CLI's) the native formatter
    (``_native.probs2str_arrays``, the same bytes), for the CPU the plain
    ``probs2str``; any other device raises."""
    import numpy as np

    from .. import _native

    if _native.on_card(device):
        return _native.probs2str_arrays(iv, jv, pv)
    iv = np.ascontiguousarray(iv, dtype=np.int32)
    jv = np.ascontiguousarray(jv, dtype=np.int32)
    pv = np.ascontiguousarray(pv, dtype=np.float32)
    return probs2str(zip(iv, jv, pv))


def probs2str(prob_items) -> str:
    """`i,j,p ` triple text for one record (bin/mccaskill_algo.rs:103-113).

    ``prob_items`` iterates (i, j, p). The reference iterates a hashmap (unordered);
    we emit in deterministic (i, j) order - same set of triples, stable layout.
    """
    return "".join(f"{int(i)},{int(j)},{_fmt(p)} " for i, j, p in prob_items)


def _fmt(p) -> str:
    """Rust's `{}` f32 Display: shortest positional repr that round-trips f32."""
    import numpy as np

    return np.format_float_positional(np.float32(p), unique=True, trim="-")
