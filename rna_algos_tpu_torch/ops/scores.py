"""Score-table helpers of the slice (``rna_algos_tpu.ops.scores``).

``sget``, the canonical-pair and AU/GU matrices, the CONTRA and Turner
2-loop length terms and the Turner special-hairpin lookup;
``contra_table_pytree`` and ``turner_table_pytree`` are
``weights.contra_tables`` and ``weights.turner_tables``.
"""

import torch

from ..constants import (
    A,
    G,
    U,
    CANONICAL_PAIRS,
    MAX_2LOOP_LEN,
    MAX_INTERIOR_ASYMMETRIC,
    MAX_INTERIOR_EXPLICIT,
    MAX_INTERIOR_SYMMETRIC,
    MAX_LOOP_LEN,
    NEG_INF,
    NUM_BASES_PAD,
    PSEUDO_BASE,
)


def canon_mat(device):
    """(5, 5) float32 canonical-pair indicator (``scores.CANON_MAT``)."""
    m = torch.zeros((NUM_BASES_PAD, NUM_BASES_PAD), dtype=torch.float32)
    for a, b in CANONICAL_PAIRS:
        m[a, b] = 1.0
    return m.to(device)


def augu_mat(device):
    """(5, 5) float32 AU/GU closing-pair indicator (``scores.AUGU_MAT``)."""
    m = torch.zeros((NUM_BASES_PAD, NUM_BASES_PAD), dtype=torch.float32)
    for a, b in ((A, U), (U, A), (G, U), (U, G)):
        m[a, b] = 1.0
    return m.to(device)


def sget(seq, idx):
    """Bases of ``seq`` (..., L) at positions ``idx`` (broadcastable to
    (..., K)), with ``jnp.take(mode="fill", fill_value=PSEUDO_BASE)``
    semantics: an index in [-L, 0) counts from the end, as in NumPy, and
    any index outside [-L, L) reads PSEUDO_BASE.  So on a full-length
    sequence position -1 reads the last base, not the fill; the tables
    only use that value in cells no pair reaches, and it is kept so the
    tables stay bitwise equal to the JAX package's."""
    L = seq.shape[-1]
    valid = (idx >= -L) & (idx < L)
    safe = torch.where(idx < 0, idx + L, idx).clamp(0, L - 1)
    safe = torch.broadcast_to(safe, seq.shape[:-1] + safe.shape[-1:])
    got = torch.gather(seq, -1, safe)
    return torch.where(valid, got, torch.full_like(got, PSEUDO_BASE))


def _contra_len_consts(ct):
    """(31, 31) [a, b] length/feature terms of the CONTRA 2-loop
    (``scores._contra_len_consts``): (bulge, interior)."""
    device = ct["bulge_scores_len_cumulative"].device
    ab = torch.arange(MAX_LOOP_LEN + 1, device=device)
    a, b = ab[:, None], ab[None, :]
    m = a + b
    bulge = ct["bulge_scores_len_cumulative"][(m - 1).clamp(0, MAX_LOOP_LEN - 1)]
    sym = ct["interior_scores_symmetric_cumulative"][
        (a - 1).clamp(0, MAX_INTERIOR_SYMMETRIC - 1)
    ]
    asym = ct["interior_scores_asymmetric_cumulative"][
        ((a - b).abs() - 1).clamp(0, MAX_INTERIOR_ASYMMETRIC - 1)
    ]
    in_explicit = (
        (a >= 1) & (a <= MAX_INTERIOR_EXPLICIT)
        & (b >= 1) & (b <= MAX_INTERIOR_EXPLICIT)
    )
    explicit = torch.where(
        in_explicit,
        ct["interior_scores_explicit"][
            (a - 1).clamp(0, MAX_INTERIOR_EXPLICIT - 1),
            (b - 1).clamp(0, MAX_INTERIOR_EXPLICIT - 1),
        ],
        torch.zeros((), device=device),
    )
    interior = (
        ct["interior_scores_len_cumulative"][(m - 2).clamp(0, MAX_LOOP_LEN - 2)]
        + torch.where(a == b, sym, asym)
        + explicit
    )
    return bulge, interior


def special_hairpin_id(seqs, tt, N):
    """(B, N, N) [i, d] special-hairpin score of [i, i+d] (closing pair
    included), NEG_INF where no special sequence matches
    (``scores.special_hairpin_id`` for a batch).

    A special sequence of length L only lands at d = L - 1, so the
    (N, N, S) select of the JAX version becomes one scatter-max of each
    special's score into its column; the lookup never syncs the host."""
    sp_seqs = tt["special_seqs"]          # (S, Lmax), -1 padded
    sp_lens = tt["special_lens"]          # (S,)
    sp_scores = tt["special_scores"]      # (S,)
    Lmax = sp_seqs.shape[1]
    dev = seqs.device
    B = seqs.shape[0]
    offs = torch.arange(Lmax, device=dev)
    idx = (torch.arange(N, device=dev)[:, None] + offs[None, :]).reshape(-1)
    win = sget(seqs, idx).view(B, N, Lmax)
    ok = (win[:, :, None, :] == sp_seqs[None, None]) | (
        offs[None, None, None, :] >= sp_lens[None, None, :, None]
    )
    match = ok.all(dim=-1)                                    # (B, N, S)
    neg = torch.full((), NEG_INF, device=dev)
    fits = (sp_lens >= 1) & (sp_lens <= N)
    sp_at = torch.where(match & fits, sp_scores[None, None, :], neg)  # (B, N, S)
    col = (sp_lens - 1).clamp(0, N - 1).expand(B, N, -1)
    out = torch.full((B, N, N), NEG_INF, device=dev)
    return out.scatter_reduce_(2, col, sp_at, reduce="amax")


def _turner_len_consts(tt):
    """(31, 31) [a, b] Turner 2-loop terms (``scores._turner_len_consts``):
    (interior init, bulge init, Ninio asymmetry)."""
    device = tt["interior_init"].device
    ab = torch.arange(MAX_LOOP_LEN + 1, device=device)
    a, b = ab[:, None], ab[None, :]
    m = a + b
    init_int = tt["interior_init"][m.clamp(0, MAX_2LOOP_LEN)]
    init_bulge = tt["bulge_init"][m.clamp(1, MAX_2LOOP_LEN)]
    ninio = torch.maximum(
        tt["ninio_coeff"] * (a - b).abs().to(torch.float32), tt["ninio_max"]
    )
    return init_int, init_bulge, ninio
