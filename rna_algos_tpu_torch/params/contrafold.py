"""CONTRAfold v2.02 scoring model: parameter schema, parser, and defaults.

Re-creation of the `rna_ss_params::compiled_scores_contra` interface plus the runtime
`FoldScoreSets` assembly of the reference (`reference/src/utils.rs:91-119` and
`reference/src/mccaskill_algo.rs:24-211`).

Two sources of weights:

* ``parse_contrafold_params(text)`` ingests a CONTRAfold v2.02 parameter file
  (``contrafold.params.complementary`` feature-name scheme: ``base_pair_XY``,
  ``helix_stacking_WXYZ``, ``terminal_mismatch_WXYZ``, ``hairpin_length_at_least_N``,
  ``bulge_length_at_least_N``, ``internal_length_at_least_N``,
  ``internal_symmetric_length_at_least_N``, ``internal_asymmetry_at_least_N``,
  ``internal_explicit_M_N``, ``bulge_0x1_nucleotides_X``,
  ``internal_1x1_nucleotides_XY``, ``helix_closing_XY``, ``dangle_left_XYZ``,
  ``dangle_right_XYZ``, ``multi_base``/``multi_unpaired``/``multi_paired``,
  ``external_unpaired``/``external_paired``).  This is the analog of the reference's
  `generate_align_scores` codegen (bin/generate_align_scores.rs) for the folding model.
* ``default_contra_tables()`` returns embedded surrogate weights derived from the
  Turner 2004 physics tables (this environment has no copy of the learned CONTRAfold
  weight file; see PARAMS.md).  Structure and semantics are exact; drop in the real
  file via the parser / `rna-algos-generate-fold-scores` CLI for the learned model.

``build_fold_score_sets`` mirrors `FoldScoreSets::new(0.)` + `transfer()` +
`accumulate()` exactly: arrays start at 0, only canonical-pair entries are
overwritten (mccaskill_algo.rs:124-203), and the five cumulative ("at least")
prefix-sum arrays are produced (mccaskill_algo.rs:60-86).
"""

import os

import numpy as np

from ..constants import (
    A,
    C,
    G,
    U,
    NUM_BASES,
    NUM_BASES_PAD,
    CANONICAL_PAIRS,
    MAX_LOOP_LEN,
    MAX_INTERIOR_SYMMETRIC,
    MAX_INTERIOR_ASYMMETRIC,
    MAX_INTERIOR_EXPLICIT,
)
from . import turner

_B = NUM_BASES_PAD
_BASE_FROM_CHAR = {"A": A, "C": C, "G": G, "U": U}


def _is_canonical(a, b):
    return (a, b) in CANONICAL_PAIRS


def _zeros(shape):
    return np.zeros(shape, dtype=np.float32)


def empty_contra_tables():
    """The raw compiled_scores_contra-equivalent arrays, all zero."""
    return {
        "hairpin_scores_len_atleast": _zeros(MAX_LOOP_LEN + 1),
        "bulge_scores_len_atleast": _zeros(MAX_LOOP_LEN),
        "interior_scores_len_atleast": _zeros(MAX_LOOP_LEN - 1),
        "interior_scores_symmetric_atleast": _zeros(MAX_INTERIOR_SYMMETRIC),
        "interior_scores_asymmetric_atleast": _zeros(MAX_INTERIOR_ASYMMETRIC),
        "stack_scores": _zeros((_B, _B, _B, _B)),
        "terminal_mismatch_scores": _zeros((_B, _B, _B, _B)),
        "dangling_scores_left": _zeros((_B, _B, _B)),
        "dangling_scores_right": _zeros((_B, _B, _B)),
        "helix_close_scores": _zeros((_B, _B)),
        "basepair_scores": _zeros((_B, _B)),
        "interior_scores_explicit": _zeros(
            (MAX_INTERIOR_EXPLICIT, MAX_INTERIOR_EXPLICIT)
        ),
        "bulge_scores_0x1": _zeros(_B),
        "interior_scores_1x1": _zeros((_B, _B)),
        "multibranch_score_base": np.float32(0.0),
        "multibranch_score_basepair": np.float32(0.0),
        "multibranch_score_unpair": np.float32(0.0),
        "external_score_basepair": np.float32(0.0),
        "external_score_unpair": np.float32(0.0),
    }


def parse_contrafold_params(text):
    """Parse CONTRAfold v2.02 feature/weight lines into the raw table dict.

    Unknown feature names are ignored (the learned file carries extra features,
    e.g. base-pair distance bins, that this model family does not consume —
    matching what the rna-ss-params codegen kept).
    """
    t = empty_contra_tables()

    def bases(s):
        return [_BASE_FROM_CHAR[ch] for ch in s]

    for line in text.splitlines():
        parts = line.split()
        if len(parts) < 2:
            continue
        name, value = parts[0], np.float32(float(parts[1]))
        if name.startswith("base_pair_") and len(name) == len("base_pair_") + 2:
            a, b = bases(name[-2:])
            t["basepair_scores"][a][b] = value
            t["basepair_scores"][b][a] = value
        elif name.startswith("helix_stacking_"):
            a, b, c, d = bases(name[-4:])
            # Feature is symmetric under strand reversal.
            t["stack_scores"][a][b][c][d] = value
            t["stack_scores"][d][c][b][a] = value
        elif name.startswith("terminal_mismatch_"):
            a, b, x, y = bases(name[-4:])
            t["terminal_mismatch_scores"][a][b][x][y] = value
        elif name.startswith("hairpin_length_at_least_"):
            i = int(name.rsplit("_", 1)[1])
            if i <= MAX_LOOP_LEN:
                t["hairpin_scores_len_atleast"][i] = value
        elif name.startswith("bulge_length_at_least_"):
            i = int(name.rsplit("_", 1)[1])
            if 1 <= i <= MAX_LOOP_LEN:
                t["bulge_scores_len_atleast"][i - 1] = value
        elif name.startswith("internal_length_at_least_"):
            i = int(name.rsplit("_", 1)[1])
            if 2 <= i <= MAX_LOOP_LEN:
                t["interior_scores_len_atleast"][i - 2] = value
        elif name.startswith("internal_symmetric_length_at_least_"):
            i = int(name.rsplit("_", 1)[1])
            if 1 <= i <= MAX_INTERIOR_SYMMETRIC:
                t["interior_scores_symmetric_atleast"][i - 1] = value
        elif name.startswith("internal_asymmetry_at_least_"):
            i = int(name.rsplit("_", 1)[1])
            if 1 <= i <= MAX_INTERIOR_ASYMMETRIC:
                t["interior_scores_asymmetric_atleast"][i - 1] = value
        elif name.startswith("internal_explicit_"):
            parts2 = name[len("internal_explicit_"):].split("_")
            i, j = int(parts2[0]), int(parts2[1])
            if 1 <= i <= MAX_INTERIOR_EXPLICIT and 1 <= j <= MAX_INTERIOR_EXPLICIT:
                t["interior_scores_explicit"][i - 1][j - 1] = value
                t["interior_scores_explicit"][j - 1][i - 1] = value
        elif name.startswith("bulge_0x1_nucleotides_"):
            (x,) = bases(name[-1:])
            t["bulge_scores_0x1"][x] = value
        elif name.startswith("internal_1x1_nucleotides_"):
            x, y = bases(name[-2:])
            t["interior_scores_1x1"][x][y] = value
        elif name.startswith("helix_closing_"):
            a, b = bases(name[-2:])
            t["helix_close_scores"][a][b] = value
        elif name.startswith("dangle_left_"):
            a, b, x = bases(name[-3:])
            t["dangling_scores_left"][a][b][x] = value
        elif name.startswith("dangle_right_"):
            a, b, x = bases(name[-3:])
            t["dangling_scores_right"][a][b][x] = value
        elif name == "multi_base":
            t["multibranch_score_base"] = value
        elif name == "multi_paired":
            t["multibranch_score_basepair"] = value
        elif name == "multi_unpaired":
            t["multibranch_score_unpair"] = value
        elif name == "external_paired":
            t["external_score_basepair"] = value
        elif name == "external_unpaired":
            t["external_score_unpair"] = value
    return t


def default_contra_tables():
    """Surrogate CONTRAfold tables derived from the Turner 2004 physics model.

    Cumulative length targets follow the Turner initiation curves so the
    "at_least" increments reproduce them after the prefix sum.
    """
    t = empty_contra_tables()
    t["stack_scores"] = turner.STACK_SCORES.copy()
    t["terminal_mismatch_scores"] = (
        0.5 * np.nan_to_num(turner.TERMINAL_MISMATCH_SCORES_HAIRPIN, neginf=0.0)
    ).astype(np.float32)
    t["dangling_scores_left"] = turner.DANGLING_SCORES_3PRIME.copy()
    t["dangling_scores_right"] = turner.DANGLING_SCORES_5PRIME.copy()

    for (a, b) in CANONICAL_PAIRS:
        t["helix_close_scores"][a][b] = turner.HELIX_AUGU_END_PENALTY * (
            1.0 if (a, b) not in ((C, G), (G, C)) else 0.0
        )
        t["basepair_scores"][a][b] = {
            (C, G): 1.30, (G, C): 1.30,
            (A, U): 0.50, (U, A): 0.50,
            (G, U): 0.10, (U, G): 0.10,
        }[(a, b)]

    def _atleast_from_cumulative(target):
        inc = np.zeros(len(target), dtype=np.float32)
        prev = 0.0
        for i, v in enumerate(target):
            inc[i] = np.float32(v - prev)
            prev = v
        return inc

    # Hairpin lengths 0..30: short hairpins strongly penalized, then the Turner
    # initiation curve.
    hp = [-8.0, -7.0, -6.0] + [
        float(turner.HAIRPIN_SCORES_INIT[i]) for i in range(3, MAX_LOOP_LEN + 1)
    ]
    t["hairpin_scores_len_atleast"] = _atleast_from_cumulative(hp)
    bg = [float(turner.BULGE_SCORES_INIT[i]) for i in range(1, MAX_LOOP_LEN + 1)]
    t["bulge_scores_len_atleast"] = _atleast_from_cumulative(bg)
    it = [-1.5, -1.8] + [
        float(turner.INTERIOR_SCORES_INIT[i]) for i in range(4, MAX_LOOP_LEN + 1)
    ]
    t["interior_scores_len_atleast"] = _atleast_from_cumulative(it)
    t["interior_scores_symmetric_atleast"] = _atleast_from_cumulative(
        [-0.5, -0.7, -0.8, -0.9, -1.0] + [-1.0] * (MAX_INTERIOR_SYMMETRIC - 5)
    )
    ninio = [min(0.97 * i, 4.86) for i in range(1, MAX_INTERIOR_ASYMMETRIC + 1)]
    t["interior_scores_asymmetric_atleast"] = _atleast_from_cumulative(
        [-v for v in ninio]
    )

    t["multibranch_score_base"] = np.float32(turner.INIT_MULTIBRANCH_BASE)
    t["multibranch_score_basepair"] = np.float32(turner.COEFF_NUM_BRANCHES)
    t["multibranch_score_unpair"] = np.float32(-0.15)
    t["external_score_basepair"] = np.float32(0.20)
    t["external_score_unpair"] = np.float32(-0.02)
    return t


def build_fold_score_sets(raw=None):
    """Assemble the runtime CONTRAfold score set (FoldScoreSets equivalent).

    Mirrors `FoldScoreSets::new(0.)` + `transfer()` + `accumulate()`
    (mccaskill_algo.rs:24-211): start from zeros, copy only canonical-pair
    entries of the pair-indexed tables, copy the length/feature arrays, then
    compute the cumulative prefix sums of the five "at least" arrays.

    With no explicit ``raw``, a real learned-weight file named by
    ``RNA_ALGOS_CONTRA_PARAMS`` (CONTRAfold v2.02
    ``contrafold.params.complementary`` layout) takes precedence over the
    embedded surrogate defaults (PARAMS.md).
    """
    if raw is None:
        path = os.environ.get("RNA_ALGOS_CONTRA_PARAMS")
        if path:
            with open(path) as f:
                raw = parse_contrafold_params(f.read())
        else:
            raw = default_contra_tables()
    out = empty_contra_tables()

    for key in (
        "hairpin_scores_len_atleast",
        "bulge_scores_len_atleast",
        "interior_scores_len_atleast",
        "interior_scores_symmetric_atleast",
        "interior_scores_asymmetric_atleast",
    ):
        n = min(len(out[key]), len(raw[key]))
        out[key][:n] = raw[key][:n]

    for a in range(NUM_BASES):
        for b in range(NUM_BASES):
            if not _is_canonical(a, b):
                continue
            for c in range(NUM_BASES):
                for d in range(NUM_BASES):
                    if _is_canonical(c, d):
                        out["stack_scores"][a][b][c][d] = raw["stack_scores"][a][b][c][d]
                    out["terminal_mismatch_scores"][a][b][c][d] = raw[
                        "terminal_mismatch_scores"
                    ][a][b][c][d]
                for x in range(NUM_BASES):
                    out["dangling_scores_left"][a][b][x] = raw["dangling_scores_left"][a][b][x]
                    out["dangling_scores_right"][a][b][x] = raw["dangling_scores_right"][a][b][x]
            out["helix_close_scores"][a][b] = raw["helix_close_scores"][a][b]
            out["basepair_scores"][a][b] = raw["basepair_scores"][a][b]

    out["interior_scores_explicit"] = raw["interior_scores_explicit"].copy()
    out["bulge_scores_0x1"] = raw["bulge_scores_0x1"].copy()
    out["interior_scores_1x1"] = raw["interior_scores_1x1"].copy()
    for key in (
        "multibranch_score_base",
        "multibranch_score_basepair",
        "multibranch_score_unpair",
        "external_score_basepair",
        "external_score_unpair",
    ):
        out[key] = np.float32(raw[key])

    # accumulate() (mccaskill_algo.rs:60-86).
    for key in (
        "hairpin_scores_len_atleast",
        "bulge_scores_len_atleast",
        "interior_scores_len_atleast",
        "interior_scores_symmetric_atleast",
        "interior_scores_asymmetric_atleast",
    ):
        out[key.replace("_atleast", "_cumulative")] = np.cumsum(
            out[key], dtype=np.float32
        )
    return out
