"""CONTRAlign v2.01 pair-HMM scores: parser + compiled defaults.

Re-creation of the reference's align-score pipeline: the codegen
`bin/generate_align_scores.rs:38-80` parses the published CONTRAlign parameter text
(`assets/contralign.params.rna`) into `src/compiled_align_scores.rs:1-19`.  Here
``parse_contralign_params`` performs the same mapping at runtime and
``DEFAULT_ALIGN_SCORES`` holds the result for the standard published RNA parameters.

Mapping quirks preserved exactly:
* ``match_to_insert`` / ``insert_extend`` / ``insert_change`` / ``insert`` (the
  first insert-state family) are deliberately DROPPED; the ``*2`` variants are the
  ones used (generate_align_scores.rs:46-59).
* ``match_XY`` weights are symmetrized over (X, Y) (generate_align_scores.rs:61-68).
* ``insert_switch`` (insert2_change) is carried but never used by the DP —
  the Durbin model has no insert<->delete transition (durbin_algo.rs:9,45; see
  SURVEY C11).
"""

import numpy as np

from ..constants import CHAR2BASE, NUM_BASES, NUM_BASES_PAD

# The published CONTRAlign v2.01 RNA parameters (public model data, identical to
# the reference asset `assets/contralign.params.rna`).
CONTRALIGN_PARAMS_RNA = """\
match_AA 0.5256508867
match_AC -0.40906402
match_AG -0.2502759109
match_AU -0.3252306723
match_CC 0.6665219366
match_CG -0.3289391181
match_CU -0.1326088918
match_GG 0.6684676551
match_GU -0.3565888168
match_UU 0.459052045
insert_A -0.002521927159
insert_C -0.08313891561
insert_G -0.07443970653
insert_U -0.01290054598
match 0.3959924457
insert -0.4431756229
insert2 -0.3488104904
match_to_match 2.50575671
match_to_insert -1.242396113
insert_extend 1.867634673
insert_change -6.969675444
match_to_insert2 0.1970448791
insert2_extend 1.014026583
insert2_change -7.346968782
"""


def parse_contralign_params(text):
    """Parse CONTRAlign parameter text into the AlignScores dict."""
    match_scores = np.zeros((NUM_BASES_PAD, NUM_BASES_PAD), dtype=np.float32)
    insert_scores = np.zeros(NUM_BASES_PAD, dtype=np.float32)
    scores = {
        "match2match_score": np.float32(0.0),
        "match2insert_score": np.float32(0.0),
        "insert_extend_score": np.float32(0.0),
        "insert_switch_score": np.float32(0.0),
        "init_match_score": np.float32(0.0),
        "init_insert_score": np.float32(0.0),
    }
    for line in text.splitlines():
        parts = line.split()
        if len(parts) < 2:
            continue
        name, value = parts[0], np.float32(float(parts[1]))
        if name == "match_to_match":
            scores["match2match_score"] = value
        elif name in ("match_to_insert", "insert_extend", "insert_change", "insert"):
            pass  # first insert family: dropped (generate_align_scores.rs:46-50)
        elif name == "match_to_insert2":
            scores["match2insert_score"] = value
        elif name == "insert2_extend":
            scores["insert_extend_score"] = value
        elif name == "insert2_change":
            scores["insert_switch_score"] = value
        elif name == "match":
            scores["init_match_score"] = value
        elif name == "insert2":
            scores["init_insert_score"] = value
        elif name.startswith("match_"):
            x, y = (CHAR2BASE[ch] for ch in name[len("match_"):])
            match_scores[x][y] = value
            match_scores[y][x] = value
        elif name.startswith("insert_"):
            (x,) = (CHAR2BASE[ch] for ch in name[len("insert_"):])
            insert_scores[x] = value
        else:
            raise ValueError(f"unknown CONTRAlign feature: {name}")
    scores["match_scores"] = match_scores
    scores["insert_scores"] = insert_scores
    return scores


def build_align_scores(text=None):
    """AlignScores dict (mirrors AlignScores::new(0.) + transfer(),
    durbin_algo.rs:25-57)."""
    return parse_contralign_params(CONTRALIGN_PARAMS_RNA if text is None else text)


DEFAULT_ALIGN_SCORES = build_align_scores()
