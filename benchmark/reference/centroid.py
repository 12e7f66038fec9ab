"""Plain gamma-centroid (maximum expected accuracy) estimator: the
benchmark's reference of the centroid stage.

A structure S of a record scores sum over its pairs (i, j) of
(gamma * p_ij - 1), a pair allowed only where p_ij > 0, pairs nested; the
fill M[i, j] is the best score on [i, j] (the recurrence of CONTRAfold's
``centroid_fold``: M[i + 1, j], M[i, j - 1], M[i + 1, j - 1] +
gamma p_ij - 1, and the splits M[i, k] + M[k + 1, j]).  It imports
nothing of the program.  ``fill`` runs in the dtype of the BPPs it is
given; ``structures`` traces back by the choices the fill made.
"""

import numpy as np
import torch

NEG_INF = float("-inf")


def fill(bpps, gammas, with_choices=False):
    """(R, N, N) upper-triangular BPPs, (G,) gammas -> (R, G, N, N) fills
    M[r, g, i, i + d] in left layout [r, g, i, d]; with ``with_choices``
    also the choice of every cell: 0 M[i + 1, j], 1 M[i, j - 1], 2 the
    pair, 3 + t the split at k = i + t."""
    dev, dt = bpps.device, bpps.dtype
    R, N, _ = bpps.shape
    G = len(gammas)
    gam = torch.as_tensor(np.asarray(gammas, np.float64), device=dev).to(
        dt).view(1, G, 1)
    i = torch.arange(N, device=dev)[:, None]
    dd = torch.arange(N, device=dev)[None, :]
    j = (i + dd).clamp(max=N - 1)
    left = torch.where(i + dd < N, torch.gather(bpps, 2, j.expand(R, N, N)),
                       torch.zeros((), dtype=dt, device=dev))
    neg = torch.full((), NEG_INF, dtype=dt, device=dev)
    zcol = torch.zeros((R, G, 1), dtype=dt, device=dev)
    P = torch.zeros((R, G, N, N), dtype=dt, device=dev)
    Q = torch.full((R, G, N, N), NEG_INF, dtype=dt, device=dev)
    choice = (torch.zeros((R, G, N, N), dtype=torch.int16, device=dev)
              if with_choices else None)
    for d in range(1, N):
        c2 = P[..., d - 1]
        c1 = torch.cat([c2[..., 1:], zcol], dim=2)
        p = left[:, None, :, d]
        m_in = (torch.cat([P[:, :, 1:, d - 2], zcol], dim=2) if d >= 2
                else torch.zeros((R, G, N), dtype=dt, device=dev))
        c3 = torch.where(p > 0.0, (m_in + gam * p) - 1.0, neg)
        c4 = torch.full((R, G, N), NEG_INF, dtype=dt, device=dev)
        t4 = torch.zeros((R, G, N), dtype=torch.long, device=dev)
        if d >= 2:
            # t in [1, d - 1]: M(i, i + t) + M(i + t + 1, i + d)
            terms = P[..., :N - d, 1:d] + Q[..., d:, :d - 1].flip(-1)
            best = terms.max(dim=3)
            c4[..., :N - d] = best.values
            t4[..., :N - d] = best.indices + 1
        cand = torch.stack([c1, c2, c3, c4])
        m_new, which = cand.max(dim=0)
        P[..., d] = m_new
        Q[..., d:, d] = m_new[..., :N - d]
        if with_choices:
            choice[..., d] = torch.where(which == 3, 3 + t4, which).to(
                torch.int16)
    return (P, choice) if with_choices else P


def best_scores(bpps, ns, gammas):
    """(R, G) numpy: the best score of each record and gamma, M[0, n - 1]."""
    P = fill(bpps, gammas)
    ns_t = torch.as_tensor(list(ns), device=bpps.device)
    R, G = P.shape[:2]
    cols = (ns_t - 1).clamp(min=0).view(R, 1).expand(R, G)
    out = P[torch.arange(R, device=bpps.device)[:, None],
            torch.arange(G, device=bpps.device)[None, :], 0, cols]
    return out.double().cpu().numpy()


def structures(bpps, ns, gammas):
    """The best structure of each record and gamma as a dot-bracket,
    [record][gamma], traced back by the fill's choices."""
    _, choice = fill(bpps, gammas, with_choices=True)
    choice = choice.cpu().numpy()
    out = []
    for r, n in enumerate(ns):
        recs = []
        for g in range(len(gammas)):
            ch = choice[r, g]
            s = ["."] * n
            stack = [(0, n - 1)]
            while stack:
                a, b = stack.pop()
                if b <= a:
                    continue
                c = int(ch[a, b - a])
                if c == 0:
                    stack.append((a + 1, b))
                elif c == 1:
                    stack.append((a, b - 1))
                elif c == 2:
                    s[a], s[b] = "(", ")"
                    stack.append((a + 1, b - 1))
                else:
                    k = a + c - 3
                    stack.append((a, k))
                    stack.append((k + 1, b))
            recs.append("".join(s))
        out.append(recs)
    return out


def pairs(structure, n):
    """The pairs of a dot-bracket of length n, or None where it is not one
    (another length, another character, unbalanced)."""
    if len(structure) != n:
        return None
    stack, out = [], []
    for k, ch in enumerate(structure):
        if ch == "(":
            stack.append(k)
        elif ch == ")":
            if not stack:
                return None
            out.append((stack.pop(), k))
        elif ch != ".":
            return None
    return None if stack else out


def score(pair_list, bpp, gamma):
    """sum over the pairs of (gamma * p_ij - 1), in float64."""
    if not pair_list:
        return 0.0
    ii, jj = np.asarray(pair_list).T
    p = np.asarray(bpp, dtype=np.float64)[ii, jj]
    return float(np.sum(gamma * p - 1.0))
