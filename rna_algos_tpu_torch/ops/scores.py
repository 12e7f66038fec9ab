"""Score-table helpers of the slice (``rna_algos_tpu.ops.scores``).

``sget``, the canonical-pair matrix and the CONTRA 2-loop length terms;
``contra_table_pytree`` is ``weights.contra_tables``.
"""

import torch

from rna_algos_tpu.constants import (
    CANONICAL_PAIRS,
    MAX_INTERIOR_ASYMMETRIC,
    MAX_INTERIOR_EXPLICIT,
    MAX_INTERIOR_SYMMETRIC,
    MAX_LOOP_LEN,
    NUM_BASES_PAD,
    PSEUDO_BASE,
)


def canon_mat(device):
    """(5, 5) float32 canonical-pair indicator (``scores.CANON_MAT``)."""
    m = torch.zeros((NUM_BASES_PAD, NUM_BASES_PAD), dtype=torch.float32)
    for a, b in CANONICAL_PAIRS:
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
