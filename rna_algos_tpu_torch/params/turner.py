"""Turner 2004 nearest-neighbor scoring tables.

Re-creation of the `rna_ss_params::compiled_scores_turner` interface consumed by the
reference (see `reference/src/utils.rs:162-411` for every access site).  The
reference pulls these from the external `rna-ss-params` crate (not vendored); here the
tables are rebuilt from the public Turner 2004 NNDB free energies (kcal/mol at 37C)
and converted to dimensionless log-Boltzmann scores via ``score = -dG / RT``.

Indexing conventions (identical to the reference's access patterns):

* ``STACK_SCORES[a][b][c][d]``: closing pair (a,b), accessible pair (c,d), i.e. the
  2x2 motif 5'-a c-3' / 3'-b d-5' (utils.rs:224-232).
* ``TERMINAL_MISMATCH_*[a][b][x][y]``: pair (a,b) with x the loop base 3'-adjacent
  to a and y the loop base 5'-adjacent to b (utils.rs:186,331-366,373,394).
* ``DANGLING_SCORES_5PRIME[a][b][x]``: x dangles on the 5' side of pair (a,b)
  (utils.rs:397); ``_3PRIME`` the 3' side (utils.rs:400).
* Length tables are indexed by loop length directly (utils.rs:175,246,306).

All base-indexed tables carry a fifth, score-neutral slot for ``PSEUDO_BASE`` so
padded batch tensors can be gathered without masking.

PROVENANCE / ACCURACY (full matrix in PARAMS.md; machine-readable split in
EXACT_PUBLISHED / TRANSCRIBED_PUBLISHED / MODEL_GENERATED / SURROGATE below,
enforced by tests/test_params_vienna.py): the stack table (Watson-Crick AND
GU-containing doubles), loop-length initiation tables, special
tri/tetra/hexaloop list, NINIO, AU/GU helix-end penalty, multibranch affine
weights, extrapolation coefficient, BOTH dangle tables (incl. the published
GU:=AU / UG:=UA wobble-row convention), and the interior/1xN/2x3/multibranch
mismatch tables (the 2004 model replaced full interior stacking tables with
sparse published bonus rules; multibranch/external mismatches are dangle
sums) carry the published Turner 2004 values.  The hairpin terminal-mismatch
table is a full offline transcription of the published table (anchor cells
test-pinned; see PARAMS.md).  The 1x1/1x2/2x2 tables implement the published
generation model (the distributed files are themselves mostly
model-generated); per-motif measured deviations are restored via the .par
drop-in.  `params.vienna` ingests a ViennaRNA
`rna_turner2004.par` to replace every table — set
``RNA_ALGOS_TURNER_PARAMS=/path/to/rna_turner2004.par`` or call
``set_tables()``.
"""

import math
import os

import numpy as np

from ..constants import (
    A,
    C,
    G,
    U,
    NUM_BASES_PAD,
    CANONICAL_PAIRS,
    RT,
    NEG_INF,
)

_B = NUM_BASES_PAD


def dg(x):
    """kcal/mol -> log-Boltzmann score."""
    return -x / RT


def _table(shape, fill=0.0):
    return np.full(shape, fill, dtype=np.float32)


# ---------------------------------------------------------------------------
# Stacks: all 21 unique published Turner 2004 nearest-neighbor doubles
# (10 Watson-Crick + 11 GU-containing), closed under the strand-reversal
# symmetry dG(a,b,c,d) == dG(d,c,b,a).
# ---------------------------------------------------------------------------
_STACK_DG = {
    # (a, b, c, d): dG37  for 5'-a c-3' / 3'-b d-5'
    (A, U, A, U): -0.93,
    (A, U, U, A): -1.10,
    (U, A, A, U): -1.33,
    (C, G, U, A): -2.08,
    (C, G, A, U): -2.11,
    (G, C, U, A): -2.24,
    (G, C, A, U): -2.35,
    (C, G, G, C): -2.36,
    (C, G, C, G): -3.26,
    (G, C, C, G): -3.42,
    # GU-containing stacks (published Turner 2004 values), closed under the
    # strand-reversal symmetry below.
    (A, U, G, U): -0.55,
    (A, U, U, G): -1.36,
    (C, G, G, U): -1.41,
    (C, G, U, G): -2.11,
    (G, C, G, U): -1.53,
    (G, C, U, G): -2.51,
    (G, U, A, U): -1.27,
    (U, A, G, U): -1.00,
    (G, U, G, U): -0.50,
    (G, U, U, G): +1.29,
    (U, G, G, U): +0.30,
    (U, G, U, G): -0.50,
}


def _close_symmetry(d):
    out = dict(d)
    for (a, b, c, e), v in d.items():
        key = (e, c, b, a)
        out.setdefault(key, v)
    return out


def build_stack_scores():
    t = _table((_B, _B, _B, _B))
    for (a, b, c, d), v in _close_symmetry(_STACK_DG).items():
        t[a][b][c][d] = dg(v)
    return t


STACK_SCORES = build_stack_scores()

# ---------------------------------------------------------------------------
# Loop-length initiation tables (Turner 2004; index = loop length).
# Lengths beyond the measured range follow the published Jacobson-Stockmayer
# extrapolation with coefficient 1.75*RT (already applied below for bulge and
# interior so plain indexing suffices up to MAX_2LOOP_LEN).
# ---------------------------------------------------------------------------
_HAIRPIN_INIT_DG = [
    math.inf, math.inf, math.inf,
    5.40, 5.60, 5.70, 5.40, 6.00, 5.50, 6.40, 6.50,
    6.60, 6.70, 6.78, 6.86, 6.94, 7.01, 7.07, 7.13, 7.19, 7.25,
    7.30, 7.35, 7.40, 7.44, 7.49, 7.53, 7.57, 7.61, 7.65, 7.69,
]
HAIRPIN_SCORES_INIT = np.array([dg(x) for x in _HAIRPIN_INIT_DG], dtype=np.float32)

_BULGE_INIT_DG = [
    math.inf,
    3.80, 2.80, 3.20, 3.60, 4.00, 4.40, 4.59, 4.70, 4.80, 4.90,
    5.00, 5.10, 5.19, 5.27, 5.34, 5.41, 5.48, 5.54, 5.60, 5.65,
    5.71, 5.76, 5.80, 5.85, 5.89, 5.94, 5.98, 6.02, 6.05, 6.09,
]
BULGE_SCORES_INIT = np.array([dg(x) for x in _BULGE_INIT_DG], dtype=np.float32)

_INTERIOR_INIT_DG = [
    math.inf, math.inf, math.inf, math.inf,
    1.10, 2.00, 2.00, 2.10, 2.30, 2.40, 2.50,
    2.60, 2.70, 2.78, 2.86, 2.94, 3.01, 3.07, 3.13, 3.19, 3.25,
    3.30, 3.35, 3.40, 3.45, 3.49, 3.53, 3.57, 3.61, 3.65, 3.69,
]
INTERIOR_SCORES_INIT = np.array([dg(x) for x in _INTERIOR_INIT_DG], dtype=np.float32)

# Hairpin length extrapolation (utils.rs:178-184): for len > 30,
# init[30] + COEFF * ln(len / 30); COEFF in score space is -1.75 (i.e. +1.75*RT
# kcal/mol in free-energy space).
COEFF_HAIRPIN_LEN_EXTRAPOLATION = np.float32(-1.75)

# ---------------------------------------------------------------------------
# NINIO asymmetric-interior penalty and helix-end penalty.
# Reference applies (NINIO_COEFF * |l1-l2|).max(NINIO_MAX) (utils.rs:307).
# ---------------------------------------------------------------------------
NINIO_COEFF = np.float32(dg(0.60))
NINIO_MAX = np.float32(dg(3.00))
HELIX_AUGU_END_PENALTY = np.float32(dg(0.50))

# Multibranch affine model (utils.rs:375, mccaskill_algo.rs:364):
# dG = a + c * branches; Turner 2004 a = 9.3, c = -0.9 kcal/mol (no per-unpaired
# term). The closing pair's branch cost is carried by COEFF_NUM_BRANCHES at the
# accessible side exactly as in the reference recurrences.
INIT_MULTIBRANCH_BASE = np.float32(dg(9.30))
COEFF_NUM_BRANCHES = np.float32(dg(-0.90))

# ---------------------------------------------------------------------------
# Dangles — published Turner 2004 values (Serra & Turner compilation, NNDB
# "dangling ends" tables; identical rows ship in ViennaRNA's
# rna_turner2004.par dangle5/dangle3 sections).  Convention matches the
# reference's access sites: ``_5PRIME[a][b][x]`` is x at position i-1 of pair
# (seq[i]=a, seq[j]=b) (utils.rs:397), ``_3PRIME[a][b][x]`` is x at j+1
# (utils.rs:400).  The 2004 set measured dangles on Watson-Crick pairs only;
# the published files carry the wobble rows as copies of the corresponding
# A-U rows (GU := AU row, UG := UA row), reproduced here.
# ---------------------------------------------------------------------------
_DANGLE3_DG = {
    # pair (a,b) -> [A, C, G, U] dangling at j+1.
    (C, G): [-1.10, -0.40, -1.30, -0.60],
    (G, C): [-1.70, -0.80, -1.70, -1.20],
    (A, U): [-0.70, -0.10, -0.70, -0.10],
    (U, A): [-0.80, -0.50, -0.80, -0.60],
    (G, U): [-0.70, -0.10, -0.70, -0.10],  # = AU row (published convention)
    (U, G): [-0.80, -0.50, -0.80, -0.60],  # = UA row
}
_DANGLE5_DG = {
    # pair (a,b) -> [A, C, G, U] dangling at i-1.
    (C, G): [-0.50, -0.30, -0.20, -0.10],
    (G, C): [-0.20, -0.30, -0.00, -0.00],
    (A, U): [-0.30, -0.30, -0.40, -0.20],
    (U, A): [-0.30, -0.10, -0.20, -0.20],
    (G, U): [-0.30, -0.30, -0.40, -0.20],  # = AU row
    (U, G): [-0.30, -0.10, -0.20, -0.20],  # = UA row
}


def _build_dangles(table_dg):
    t = _table((_B, _B, _B))
    for (a, b), row in table_dg.items():
        for x, v in enumerate(row):
            t[a][b][x] = dg(v)
    return t


DANGLING_SCORES_5PRIME = _build_dangles(_DANGLE5_DG)
DANGLING_SCORES_3PRIME = _build_dangles(_DANGLE3_DG)

# ---------------------------------------------------------------------------
# Hairpin terminal mismatches — the published Turner 2004 table (NNDB
# "hairpin loops" terminal mismatch / RNAstructure tstackh / ViennaRNA
# mismatch_hairpin), transcribed offline; see PARAMS.md for the per-table
# fidelity notes and the literature anchor cells pinned by
# tests/test_params_vienna.py (CG closures with G.A / G.G / U.U first
# mismatches are the classic stabilized motifs).  Values are pure stacking
# terms: the AU/GU closure penalty is NOT baked in (the scoring code adds
# HELIX_AUGU_END_PENALTY separately, mirroring utils.rs:188-195).
# [a][b][x][y]: pair (a,b), x = loop base at i+1, y = loop base at j-1.
# ---------------------------------------------------------------------------
_MISMATCH_HAIRPIN_DG = {
    # rows x = A, C, G, U; cols y = A, C, G, U
    (C, G): [
        [-1.50, -1.50, -1.40, -1.80],
        [-1.00, -1.10, -1.00, -0.80],
        [-2.30, -1.50, -2.40, -1.50],
        [-1.00, -1.40, -1.00, -2.10],
    ],
    (G, C): [
        [-1.10, -1.50, -1.30, -2.10],
        [-1.10, -0.70, -1.10, -0.50],
        [-2.40, -2.90, -1.40, -1.20],
        [-1.90, -1.00, -2.20, -1.50],
    ],
    (A, U): [
        [-0.80, -1.00, -0.80, -1.00],
        [-0.60, -0.70, -0.60, -0.70],
        [-1.70, -1.00, -1.20, -1.00],
        [-0.70, -0.70, -0.70, -1.10],
    ],
    (U, A): [
        [-1.00, -0.80, -1.10, -0.90],
        [-0.70, -0.60, -0.70, -0.70],
        [-1.80, -0.90, -1.60, -0.90],
        [-0.80, -0.60, -0.80, -1.20],
    ],
    (G, U): [
        [-0.80, -1.00, -1.00, -1.00],
        [-0.70, -0.70, -0.70, -0.70],
        [-1.50, -1.00, -1.40, -1.00],
        [-0.80, -0.80, -0.80, -1.20],
    ],
    (U, G): [
        [-1.00, -0.80, -1.10, -0.90],
        [-0.70, -0.60, -0.70, -0.70],
        [-1.50, -1.00, -1.30, -0.90],
        [-0.90, -0.70, -0.90, -1.10],
    ],
}


def _build_mismatch_hairpin():
    t = _table((_B, _B, _B, _B))
    for (a, b), rows in _MISMATCH_HAIRPIN_DG.items():
        for x in range(4):
            for y in range(4):
                t[a][b][x][y] = dg(rows[x][y])
    return t


TERMINAL_MISMATCH_SCORES_HAIRPIN = _build_mismatch_hairpin()

# ---------------------------------------------------------------------------
# Interior-loop terminal mismatches — Turner 2004 replaced the 1999
# full-stacking interior mismatch table with a SPARSE bonus rule
# (Mathews et al. 2004, PNAS 101:7287, internal-loop model; NNDB "internal
# loops"): first mismatches contribute 0 except A.G / G.A (-0.8 kcal/mol)
# and U.U (-0.7); 1xN loops get NO mismatch bonus at all; 2x3 loops use the
# same bonuses as generic interiors.
#
# Closure-penalty convention (ADVICE round 3): the published internal-loop
# model charges 0.7 kcal/mol per AU/GU *closing pair of an interior loop* —
# the value the 1x1/1x2/2x2 tables below bake in, and the value a ViennaRNA
# `.par` ingest nets on this path (the file rows bake 0.7; the loader unbakes
# the file's 0.5 Misc terminal-AU; the scoring code re-adds the generic 0.5
# HELIX_AUGU_END_PENALTY).  The scoring code's separate penalty on the
# generic-interior path is the helix-end 0.5 (utils.rs:316-319 analog), so
# these tables carry the 0.2 kcal/mol closure differential on the AU/UA/GU/UG
# rows — every cell, since the reference adds the mismatch lookup
# unconditionally per closure — making default and `.par` paths agree at a
# net 0.7 per wobble-closed interior closure.
# ---------------------------------------------------------------------------
_INTERIOR_FIRST_MISMATCH_DG = {
    (A, G): -0.80,
    (G, A): -0.80,
    (U, U): -0.70,
}

# per AU/GU closing pair: published interior closure 0.7 minus the generic
# 0.5 helix-end penalty the scoring code adds on this path
_INT_MISMATCH_CLOSURE_EXTRA_DG = 0.20
_WOBBLE_END_PAIRS = ((A, U), (U, A), (G, U), (U, G))


def _build_mismatch_interior(bonuses):
    t = _table((_B, _B, _B, _B))
    for (a, b) in CANONICAL_PAIRS:
        extra = _INT_MISMATCH_CLOSURE_EXTRA_DG if (a, b) in _WOBBLE_END_PAIRS else 0.0
        for x in range(4):
            for y in range(4):
                t[a][b][x][y] = dg(bonuses.get((x, y), 0.0) + extra)
    return t


TERMINAL_MISMATCH_SCORES_INTERIOR = _build_mismatch_interior(
    _INTERIOR_FIRST_MISMATCH_DG
)
TERMINAL_MISMATCH_SCORES_1XMANY = _build_mismatch_interior({})  # no bonuses
TERMINAL_MISMATCH_SCORES_2X3 = _build_mismatch_interior(
    _INTERIOR_FIRST_MISMATCH_DG
)

# ---------------------------------------------------------------------------
# Multibranch / external terminal mismatches — the Turner 2004 model scores
# terminal stacking in multibranch and exterior loops as the SUM of the two
# published dangles (NNDB "coaxial stacking & multibranch loops"; the same
# rule generates RNAstructure's tstackm and ViennaRNA's
# mismatch_multi/mismatch_exterior).  Derived exactly from the published
# dangle tables above; both reference access sites
# ([a][b][i-1][j+1] exterior, utils.rs:394; [b][a][j-1][i+1] multibranch
# close, utils.rs:373) are physically consistent with this construction.
# ---------------------------------------------------------------------------


def _build_mismatch_dangle_sum():
    t = _table((_B, _B, _B, _B))
    for (a, b) in CANONICAL_PAIRS:
        for x in range(4):
            for y in range(4):
                t[a][b][x][y] = dg(
                    _DANGLE5_DG[(a, b)][x] + _DANGLE3_DG[(a, b)][y]
                )
    return t


TERMINAL_MISMATCH_SCORES_MULTIBRANCH = _build_mismatch_dangle_sum()

# ---------------------------------------------------------------------------
# Special hairpins (utils.rs:198-205): full subsequence including the closing
# pair -> total loop free energy. Published Turner 2004 tri/tetra/hexaloop
# tables (2 + 16 + 4 entries).
# ---------------------------------------------------------------------------
_SPECIAL_HAIRPINS_DG = [
    ("CAACG", 6.80),
    ("GUUAC", 6.90),
    ("CAACGG", 5.50),
    ("CCAAGG", 3.30),
    ("CCACGG", 3.70),
    ("CCCAGG", 3.40),
    ("CCGAGG", 3.50),
    ("CCGCGG", 3.60),
    ("CCUAGG", 3.70),
    ("CCUCGG", 2.50),
    ("CUAAGG", 3.60),
    ("CUACGG", 2.80),
    ("CUCAGG", 3.70),
    ("CUCCGG", 2.70),
    ("CUGCGG", 2.80),
    ("CUUAGG", 3.50),
    ("CUUCGG", 3.70),
    ("CUUUGG", 3.70),
    ("ACAGUGCU", 2.90),
    ("ACAGUGAU", 3.60),
    ("ACAGUGUU", 1.80),
    ("ACAGUACU", 2.80),
]

_BASE_FROM_CHAR = {"A": A, "C": C, "G": G, "U": U}


def build_special_hairpins():
    """Return (padded int array [S, Lmax], lengths [S], scores [S])."""
    seqs = [[_BASE_FROM_CHAR[ch] for ch in s] for s, _ in _SPECIAL_HAIRPINS_DG]
    scores = np.array([dg(v) for _, v in _SPECIAL_HAIRPINS_DG], dtype=np.float32)
    lmax = max(len(s) for s in seqs)
    arr = np.full((len(seqs), lmax), -1, dtype=np.int32)
    lens = np.zeros(len(seqs), dtype=np.int32)
    for i, s in enumerate(seqs):
        arr[i, : len(s)] = s
        lens[i] = len(s)
    return arr, lens, scores


HAIRPIN_SPECIAL_SEQS, HAIRPIN_SPECIAL_LENS, HAIRPIN_SPECIAL_SCORES = (
    build_special_hairpins()
)

# ---------------------------------------------------------------------------
# Small interior-loop tables: 1x1, 1x2, 2x2 (utils.rs:273-304).
#
# The published Turner 2004 tables themselves are mostly MODEL-GENERATED:
# only a small subset of motifs was measured, and the distributed
# int11/int21/int22 files fill the rest from the published generation rules
# (Mathews et al. 2004 supplement; NNDB "internal loops" pages: 1x1/2x2
# estimation).  These builders implement those rules — loop-specific base
# initiation + 0.7 kcal/mol per AU/GU closing pair (the internal-loop
# closure value, distinct from the 0.5 helix-end penalty) + the published
# mismatch stabilizations — plus the classic measured anchors (U.U and G.G
# 1x1 loops).  Unlike the generic-interior path, the reference reads these
# tables WITHOUT adding HELIX_AUGU_END_PENALTY (utils.rs:273-304), so the
# closure penalties are baked in here, exactly as in the published files.
# Residual per-motif measured deviations can be restored via the
# RNA_ALGOS_TURNER_PARAMS .par drop-in (params/vienna.py).
# ---------------------------------------------------------------------------

_INT_CLOSURE_DG = 0.70  # per AU/GU closing pair, internal-loop value


def _int_closure(a, b):
    return _INT_CLOSURE_DG if (a, b) in ((A, U), (U, A), (G, U), (U, G)) else 0.0


# 1x1 loops: base 0.9 with U.U (-1.3 -> net -0.4 between CG pairs) and G.G
# (-2.3 -> net -1.4) stabilizations, the two measured 1x1 classes the 2004
# model singles out.
_INT11_BASE_DG = 0.90
_INT11_MISMATCH_DG = {(U, U): -1.30, (G, G): -2.30}
# 1x2 loops: flat base 2.7 (1xN-type side: no first-mismatch bonuses).
_INT21_BASE_DG = 2.70
# 2x2 loops: base = the 4-nt interior initiation (1.1) with the generic
# first-mismatch bonuses applied per side (A.G/G.A -0.8, U.U -0.7, G.G -0.8
# for tandem-capable mismatches).
_INT22_BASE_DG = 1.10
_INT22_MISMATCH_DG = {
    (A, G): -0.80,
    (G, A): -0.80,
    (U, U): -0.70,
    (G, G): -0.80,
}


def build_interior_1x1():
    t = _table((_B, _B, _B, _B, _B, _B))
    for (a, b) in CANONICAL_PAIRS:
        for (c, d) in CANONICAL_PAIRS:
            for x in range(4):
                for y in range(4):
                    v = _INT11_BASE_DG + _int_closure(a, b) + _int_closure(c, d)
                    v += _INT11_MISMATCH_DG.get((x, y), 0.0)
                    # index: [close][x, y mismatch][accessible]
                    t[a][b][x][y][c][d] = dg(v)
    return t


def build_interior_1x2():
    t = _table((_B, _B, _B, _B, _B, _B, _B))
    for (a, b) in CANONICAL_PAIRS:
        for (c, d) in CANONICAL_PAIRS:
            for x in range(4):
                for y in range(4):
                    for z in range(4):
                        v = (
                            _INT21_BASE_DG
                            + _int_closure(a, b)
                            + _int_closure(c, d)
                        )
                        t[a][b][x][y][z][c][d] = dg(v)
    return t


def build_interior_2x2():
    t = _table((_B, _B, _B, _B, _B, _B, _B, _B))
    for (a, b) in CANONICAL_PAIRS:
        for (c, d) in CANONICAL_PAIRS:
            for x in range(4):
                for y in range(4):
                    for x2 in range(4):
                        for y2 in range(4):
                            v = (
                                _INT22_BASE_DG
                                + _int_closure(a, b)
                                + _int_closure(c, d)
                            )
                            v += _INT22_MISMATCH_DG.get((x, y), 0.0)
                            v += _INT22_MISMATCH_DG.get((x2, y2), 0.0)
                            t[a][b][x][y][x2][y2][c][d] = dg(v)
    return t


INTERIOR_SCORES_1X1 = build_interior_1x1()
INTERIOR_SCORES_1X2 = build_interior_1x2()
INTERIOR_SCORES_2X2 = build_interior_2x2()

# ---------------------------------------------------------------------------
# Table registry + drop-in replacement (PARAMS.md).
#
# EXACT_PUBLISHED tables carry the published Turner 2004 values verbatim
# (cross-checked against the NNDB / ViennaRNA rna_turner2004.par layout);
# SURROGATE tables are structurally exact but numerically reconstructed —
# replace them by pointing RNA_ALGOS_TURNER_PARAMS at a ViennaRNA .par file
# (params/vienna.py) or by calling set_tables().
# ---------------------------------------------------------------------------

TABLE_NAMES = (
    "STACK_SCORES",
    "HAIRPIN_SCORES_INIT",
    "BULGE_SCORES_INIT",
    "INTERIOR_SCORES_INIT",
    "COEFF_HAIRPIN_LEN_EXTRAPOLATION",
    "NINIO_COEFF",
    "NINIO_MAX",
    "HELIX_AUGU_END_PENALTY",
    "INIT_MULTIBRANCH_BASE",
    "COEFF_NUM_BRANCHES",
    "DANGLING_SCORES_5PRIME",
    "DANGLING_SCORES_3PRIME",
    "TERMINAL_MISMATCH_SCORES_HAIRPIN",
    "TERMINAL_MISMATCH_SCORES_INTERIOR",
    "TERMINAL_MISMATCH_SCORES_1XMANY",
    "TERMINAL_MISMATCH_SCORES_2X3",
    "TERMINAL_MISMATCH_SCORES_MULTIBRANCH",
    "HAIRPIN_SPECIAL_SEQS",
    "HAIRPIN_SPECIAL_LENS",
    "HAIRPIN_SPECIAL_SCORES",
    "INTERIOR_SCORES_1X1",
    "INTERIOR_SCORES_1X2",
    "INTERIOR_SCORES_2X2",
)

EXACT_PUBLISHED = (
    "STACK_SCORES",
    "HAIRPIN_SCORES_INIT",
    "BULGE_SCORES_INIT",
    "INTERIOR_SCORES_INIT",
    "COEFF_HAIRPIN_LEN_EXTRAPOLATION",
    "NINIO_COEFF",
    "NINIO_MAX",
    "HELIX_AUGU_END_PENALTY",
    "INIT_MULTIBRANCH_BASE",
    "COEFF_NUM_BRANCHES",
    "HAIRPIN_SPECIAL_SEQS",
    "HAIRPIN_SPECIAL_LENS",
    "HAIRPIN_SPECIAL_SCORES",
    # round 3 (VERDICT item 1): published values / published derivation
    # rules embedded — see PARAMS.md for per-table provenance + anchors.
    "DANGLING_SCORES_5PRIME",
    "DANGLING_SCORES_3PRIME",
    "TERMINAL_MISMATCH_SCORES_INTERIOR",   # sparse 2004 bonus rule
    "TERMINAL_MISMATCH_SCORES_1XMANY",     # published: no bonuses
    "TERMINAL_MISMATCH_SCORES_2X3",        # sparse 2004 bonus rule
    "TERMINAL_MISMATCH_SCORES_MULTIBRANCH",  # = dangle sums (2004 rule)
)

# Offline transcription of a full published table: every cell carries the
# published-table intent, but per-cell fidelity rests on the transcription
# (anchor cells pinned by tests; PARAMS.md documents the residual risk).
TRANSCRIBED_PUBLISHED = (
    "TERMINAL_MISMATCH_SCORES_HAIRPIN",
)

# Generated by the PUBLISHED generation model (the distributed files are
# themselves mostly model-generated; measured per-motif deviations are
# restored via the .par drop-in).
MODEL_GENERATED = (
    "INTERIOR_SCORES_1X1",
    "INTERIOR_SCORES_1X2",
    "INTERIOR_SCORES_2X2",
)

SURROGATE = tuple(
    n
    for n in TABLE_NAMES
    if n not in EXACT_PUBLISHED
    and n not in TRANSCRIBED_PUBLISHED
    and n not in MODEL_GENERATED
)


def default_tables():
    """The embedded tables as a dict (copies are NOT made; treat read-only)."""
    return {name: globals()[name] for name in TABLE_NAMES}


_active = None


def active_tables():
    """Embedded defaults, overridden by RNA_ALGOS_TURNER_PARAMS (.par file)
    and/or a prior set_tables() call.  Cached after first use."""
    global _active
    if _active is None:
        tabs = default_tables()
        path = os.environ.get("RNA_ALGOS_TURNER_PARAMS")
        if path:
            from . import vienna

            tabs.update(
                (k, v)
                for k, v in vienna.load_turner_params(path).items()
                if k in tabs
            )
        _active = tabs
    return _active


def set_tables(overrides=None):
    """Install table overrides (dict keyed by TABLE_NAMES) or reset (None).

    Callers must rebuild any jit-captured table pytrees afterwards
    (ops.scores.turner_table_pytree reads active_tables() at call time).
    """
    global _active
    if overrides is None:
        _active = None
        return
    tabs = default_tables()
    unknown = set(overrides) - set(TABLE_NAMES)
    if unknown:
        raise KeyError(f"unknown Turner table names: {sorted(unknown)}")
    tabs.update(overrides)
    _active = tabs
