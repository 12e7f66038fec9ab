"""The work a fold must do, counted by the algorithm, and the card's peaks.

The count depends on the sequences alone: not on the kernel, the numerics
tier, the bucket's padding, the fusion or the number of re-runs that
computes it.  It counts the terms of McCaskill's inside and outside
recurrences (as the program and the reference write them) at each
sequence's live cells (i < j < n, span d = j - i), each term a multiply
and an add:

inside, at every live cell: ext d + 1 terms, s1 d, s2 max(d - 1, 0),
one 2, rm 2; at a cell that can close (a canonical pair, d + 1 >=
MIN_SPAN): hairpin 1, multibranch 1 and the 2-loop window, the (a, b)
with a + b <= 30 whose inner pair (i + 1 + a, j - 1 - b) spans at least
MIN_SPAN;
outside, at every live cell with d + 1 >= MIN_SPAN: pm and pm2 n - 1 - j
terms each; at a cell that can close: base 1, combine 2, the multibranch
context 3 i, and the 2-loop window, the (a, b) with a + b <= 30 whose
outer pair (i - 1 - a, j + 1 + b) lies in the sequence.

Bytes: each sequence read once (a byte a base), the model's parameter
tables once a call (float32), each sequence's (n, n) output written once
(a float32 probability and a byte of presence a cell).
"""

import torch

MIN_SPAN = 5           # the shortest span j - i + 1 of a pair
WINDOW = 31            # loop lengths 0..30 on each side of a 2-loop
FLOPS_PER_TERM = 2
OUT_BYTES_PER_CELL = 5
CANONICAL = ((0, 3), (1, 2), (2, 1), (2, 3), (3, 0), (3, 2))

# Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the 700 W
# power limit): HBM3 bytes/s and float32 FLOP/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def _inside_window(dev):
    """[d] the inside window terms of a closing cell of span d."""
    d = torch.arange(4096, device=dev)
    m = torch.clamp(d - 1 - MIN_SPAN, max=WINDOW - 1)
    return torch.where(m >= 0, (m + 1) * (m + 2) // 2, 0)


def _outside_window(dev):
    """[x, y] the outside window terms of a cell with x = min(i, 31)
    positions to its left and y = min(n - 1 - j, 31) to its right."""
    a = torch.arange(WINDOW, device=dev)[:, None]
    b = torch.arange(WINDOW, device=dev)[None, :]
    ok = (a + b <= WINDOW - 1).to(torch.int64)
    table = torch.zeros((WINDOW + 1, WINDOW + 1), dtype=torch.int64,
                        device=dev)
    table[1:, 1:] = ok.cumsum(0).cumsum(1)
    return table


def terms(seqs, device="cpu", cells=1 << 24):
    """Recurrence terms of folding each of ``seqs`` (sequences of base
    codes 0-3): a list of ints.  Blocks of sequences of at most ``cells``
    (B, N, N) cells at a time."""
    dev = torch.device(device)
    win_in, win_out = _inside_window(dev), _outside_window(dev)
    canon = torch.zeros((5, 5), dtype=torch.bool, device=dev)
    for a, b in CANONICAL:
        canon[a, b] = True
    out = []
    s0 = 0
    while s0 < len(seqs):
        N = max(len(s) for s in seqs[s0:s0 + 256])
        part = seqs[s0:s0 + max(1, cells // max(N * N, 1))]
        s0 += len(part)
        B, N = len(part), max(len(s) for s in part)
        x = torch.full((B, N), 4, dtype=torch.int64)
        for k, s in enumerate(part):
            x[k, :len(s)] = torch.as_tensor(s, dtype=torch.int64)
        x = x.to(dev)
        n = torch.as_tensor([len(s) for s in part], device=dev).view(B, 1, 1)
        i = torch.arange(N, device=dev).view(1, N, 1)
        d = torch.arange(N, device=dev).view(1, 1, N)
        j = i + d
        live = j < n
        jc = j.clamp(max=N - 1).expand(B, N, N)
        xj = torch.gather(x[:, None, :].expand(B, N, N), 2, jc)
        xi = x[:, :, None].expand(B, N, N)
        close = live & canon[xi, xj] & (d + 1 >= MIN_SPAN)
        right = (n - 1 - j).clamp(min=0)
        inside = torch.where(live, 3 * d + 4 + (d == 0).to(torch.int64), 0)
        inside = inside + torch.where(close, 2 + win_in[d], 0)
        outside = torch.where(live & (d + 1 >= MIN_SPAN), 2 * right, 0)
        wo = win_out[i.clamp(max=WINDOW).expand(B, N, N),
                     right.clamp(max=WINDOW)]
        outside = outside + torch.where(close, 3 + 3 * i + wo, 0)
        out.extend((inside + outside).sum(dim=(1, 2)).tolist())
    return out


def centroid_terms(n, gammas):
    """Terms of the gamma-centroid fill of a length-n record for each of
    ``gammas`` gammas: at each cell of span d >= 1, the three candidates
    and the d - 1 splits (an add and a max each)."""
    d = torch.arange(1, max(n, 1), dtype=torch.int64)
    return gammas * int(((n - d) * (d + 2)).sum())


def call_work(seqs, param_bytes, device="cpu"):
    """(FLOPs, bytes) the fold of one call over ``seqs`` must do."""
    flops = FLOPS_PER_TERM * sum(terms(seqs, device))
    nbytes = (sum(len(s) for s in seqs) + param_bytes
              + OUT_BYTES_PER_CELL * sum(len(s) ** 2 for s in seqs))
    return flops, nbytes


def least_seconds(flops, nbytes):
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the FLOPs over the float32 rate."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_PER_S)
