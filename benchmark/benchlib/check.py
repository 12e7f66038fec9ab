"""The comparison that decides ``correct``: the program's outputs on a
sample of the window's calls against the plain reference, run after the
window has closed, on inputs the benchmark made.

Numbers compared (each against its limit in ``checks/<cell>.json``):

- ``bpp_gap``: the largest |reported - reference| probability over every
  cell of every sampled sequence, a reported probability being the
  program's BPP where its presence matrix holds the pair and 0 where it
  does not (so both matrices are compared); a call whose outputs are not
  one (n, n) pair of matrices for each of its sequences reads infinite;
- where the traffic asks for structures, ``centroid_gap``: over every
  sampled record and gamma, how far the program's structure's expected
  accuracy, sum over its pairs of (gamma p - 1) with the reference's p,
  lies below the reference's best, divided by gamma (a probability); a
  structure that is no dot-bracket of the record's length, or a gamma
  without one structure for each record, reads infinite.
"""

import heapq
import math

import numpy as np
import torch

# A block of the reference holds at most this many (B, N, N) cells.
REF_CELLS = 1 << 24
# The calls of a run that are compared, drawn from the seed.
CHECK_CALLS = 1


def delivered(results, structures, gammas):
    """The sequences whose outputs a call returned: its (bpp, presence)
    pairs and, with ``gammas``, a structure for each gamma."""
    n = len(results)
    if gammas is not None:
        n = min([n] + [len((structures or {}).get(g, ())) for g in gammas])
    return n


class Sampler:
    """Keeps the outputs of the ``k`` calls of lowest priority seen so far;
    the priorities are drawn from ``rng`` (the seed's sample stream), one a
    call in the order the calls are offered."""

    def __init__(self, k, rng):
        self.k = k
        self.rng = rng
        self.heap = []                      # (-priority, index, record)

    def offer(self, index, record):
        item = (-float(self.rng.random()), index, record)
        if len(self.heap) < self.k:
            heapq.heappush(self.heap, item)
        elif item[0] > self.heap[0][0]:
            heapq.heapreplace(self.heap, item)

    def records(self):
        return [rec for _, _, rec in sorted(self.heap, key=lambda x: x[1])]


def blocks(seqs):
    """Index blocks of ``seqs`` by length, each under REF_CELLS cells."""
    order = sorted(range(len(seqs)), key=lambda k: len(seqs[k]))
    out, cur = [], []
    for k in order:
        N = len(seqs[k])
        if cur and (len(cur) + 1) * N * N > REF_CELLS:
            out.append(cur)
            cur = []
        cur.append(k)
    if cur:
        out.append(cur)
    return out


def reference_bpps(seqs, ref_tables, model, device):
    """The reference's (n, n) BPPs of every sequence, float64 numpy, in
    blocks of similar length."""
    from reference import mccaskill as R

    out = [None] * len(seqs)
    for block in blocks(seqs):
        N = max(len(seqs[k]) for k in block)
        x = torch.full((len(block), N), R.PSEUDO_BASE, dtype=torch.int64)
        for r, k in enumerate(block):
            x[r, :len(seqs[k])] = torch.as_tensor(seqs[k], dtype=torch.int64)
        ns = torch.as_tensor([len(seqs[k]) for k in block])
        bpp = R.bpp(x.to(device), ns.to(device), ref_tables, model)
        bpp = bpp.double().cpu().numpy()
        for r, k in enumerate(block):
            n = len(seqs[k])
            out[k] = bpp[r, :n, :n]
    return out


def bpp_numbers(results, refs):
    if len(results) != len(refs):
        return {"bpp_gap": math.inf}
    gap = 0.0
    for out, ref in zip(results, refs):
        if len(out) != 2 or any(np.shape(m) != ref.shape for m in out):
            return {"bpp_gap": math.inf}
        bpp, presence = out
        reported = np.where(np.asarray(presence, bool),
                            np.asarray(bpp, np.float64), 0.0)
        diff = np.abs(reported - ref)
        gap = max(gap, float(np.nan_to_num(diff, nan=np.inf).max()))
    return {"bpp_gap": gap}


def centroid_numbers(structures, refs, gammas, device):
    """The centroid numbers of one call's structures ({gamma: [dot-bracket
    per record]}) against the reference's BPPs of its records."""
    from reference import centroid as RC

    if not isinstance(structures, dict) or any(
            len(structures.get(g, ())) != len(refs) for g in gammas):
        return {"centroid_gap": math.inf}
    gap = 0.0
    for block in blocks(refs):
        N = max(len(refs[k]) for k in block)
        padded = np.zeros((len(block), N, N))
        for r, k in enumerate(block):
            n = len(refs[k])
            padded[r, :n, :n] = refs[k]
        best = RC.best_scores(torch.as_tensor(padded, device=device),
                              [len(refs[k]) for k in block], gammas)
        for r, k in enumerate(block):
            n = len(refs[k])
            for g, gamma in enumerate(gammas):
                pl = RC.pairs(structures[gamma][k], n)
                if pl is None:
                    return {"centroid_gap": math.inf}
                got = RC.score(pl, refs[k], float(gamma))
                gap = max(gap, (best[r, g] - got) / float(gamma))
    return {"centroid_gap": gap}


def compare(records, ref_tables, model, gammas, device):
    """The numbers compared over the sampled calls: ``records`` are dicts
    with the call's ``seqs``, the program's ``results`` and, with
    ``gammas``, its ``structures``."""
    numbers = {}
    for rec in records:
        refs = reference_bpps(rec["seqs"], ref_tables, model, device)
        got = bpp_numbers(rec["results"], refs)
        if gammas is not None:
            got.update(centroid_numbers(rec["structures"], refs, gammas,
                                        device))
        for k, v in got.items():
            numbers[k] = max(numbers.get(k, v), v)
    return numbers


def verdict(numbers, limits):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number that is not finite fails."""
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in numbers.items()}
    ok = bool(numbers) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    return ok, checks
