"""The traffic generator: one general generator, read from a traffic file.

A traffic file gives a call's ``batch`` and how its sequences are made:

- ``templates`` (name -> RNA sequence) with ``substitution_rate``: each
  call holds ``batch / len(templates)`` variants of every template, each
  position replaced by one of the three other bases with that
  probability, in an order drawn from the seed;
- otherwise ``length_min`` .. ``length_max``: uniform random ACGU
  sequences whose lengths are drawn uniformly in that range, stratified
  over the call (the k-th of B lengths lies in the k-th B-quantile of the
  range), so every call and every seed carries about the same work.

Every call is new sequences; the pool is made before the window opens.
"""

import numpy as np

BASES = {"A": 0, "C": 1, "G": 2, "U": 3}
TRAFFIC, WARMUP, SAMPLE = 1, 2, 3
# The window's calls made ahead, against the pace of the fastest warm call.
POOL_HEADROOM = 2.0


def rng(seed, stream):
    """The generator of one stream of a run: the seed is any whole number
    (taken modulo 2^64)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def encode(seq):
    return np.array([BASES[c] for c in seq.upper().replace("T", "U")],
                    dtype=np.int8)


def _variants(traffic, g):
    temps = [encode(s) for s in traffic["templates"].values()]
    copies, rest = divmod(int(traffic["batch"]), len(temps))
    if rest:
        raise ValueError("a variants batch is a whole number of copies of "
                         "the templates")
    rate = float(traffic["substitution_rate"])
    out = []
    for t in temps:
        for _ in range(copies):
            hit = g.random(len(t)) < rate
            shift = g.integers(1, 4, size=len(t), dtype=np.int8)
            out.append(np.where(hit, (t + shift) % 4, t).astype(np.int8))
    return [out[k] for k in g.permutation(len(out))]


def _uniform(traffic, g):
    B = int(traffic["batch"])
    lo, hi = int(traffic["length_min"]), int(traffic["length_max"])
    width = hi - lo + 1
    lengths = lo + np.floor((np.arange(B) + g.random(B)) * width / B
                            ).astype(np.int64)
    lengths = np.minimum(lengths, hi)[g.permutation(B)]
    return [g.integers(0, 4, size=int(n), dtype=np.int8) for n in lengths]


def call(traffic, g):
    """One call's sequences: a list of int8 arrays of base codes."""
    if "templates" in traffic:
        return _variants(traffic, g)
    return _uniform(traffic, g)


def pool(traffic, seed, calls, stream=TRAFFIC):
    """``calls`` calls of the traffic for ``seed``."""
    g = rng(seed, stream)
    return [call(traffic, g) for _ in range(calls)]


def pool_size(seconds, call_s):
    """Calls made ready for a window of ``seconds`` at ``call_s`` seconds a
    call (taken as 1 ms at the least): POOL_HEADROOM times as many, and at
    least 8."""
    return max(8, int(np.ceil(POOL_HEADROOM * seconds / max(call_s, 1e-3))))
