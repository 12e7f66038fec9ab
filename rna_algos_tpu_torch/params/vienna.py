"""ViennaRNA parameter-file (.par) ingestion for the Turner 2004 tables.

The reference consumes the Turner 2004 model through the `rna-ss-params`
crate (`reference/Cargo.toml:12`, `src/utils.rs:8-10`), whose tables
were generated from the published Turner 2004 NNDB values — the same values
shipped as ViennaRNA's ``rna_turner2004.par``.  This module is the promised
drop-in ingestion path (PARAMS.md): given a ``.par`` file it rebuilds every
table of :mod:`params.turner` with the published numbers,
replacing the embedded defaults (which are exact for some tables and
best-effort for others — see PARAMS.md for the per-table provenance).

Supported sections (ViennaRNA v2.0 text format, values in dekacal/mol,
``INF`` for forbidden):

  stack, mismatch_hairpin, mismatch_interior, mismatch_interior_1n,
  mismatch_interior_23, mismatch_multi, mismatch_exterior, dangle5,
  dangle3, int11, int21, int22, hairpin, bulge, interior, NINIO,
  ML_params, Misc, Triloops, Tetraloops, Hexaloops

``*_enthalpies`` sections are skipped (the model is 37C free energies).

Index mapping (derived from ViennaRNA's ``E_IntLoop``/``E_Hairpin`` access
conventions vs the reference's scalar scoring functions, utils.rs:162-411):

* pair order in .par tables: CG GC GU UG AU UA (then NN where present);
  base order: N A C G U in 5-wide dims, A C G U in 4-wide dims.
* ``stack[t1][t2]`` scores outer pair t1 = (i, j) with t2 = (j-1, i+1), the
  REVERSED inner pair -> ``STACK_SCORES[a][b][c][d] = stack[T(a,b)][T(d,c)]``
  for motif 5'-a c-3' / 3'-b d-5'.
* mismatch tables are direct: ``TM[a][b][x][y] = mm[T(a,b)][x][y]`` with
  x = base 3' of a, y = base 5' of b (utils.rs:186).
* ``int11[t1][t2][x][y]`` -> ``INTERIOR_SCORES_1X1[a][b][x][y][c][d]`` with
  t2 = T(d, c).
* ``int21[t1][t2][x][z][y]`` stores the 1-nt side first and the 3'-most
  2-nt-side base LAST -> ``INTERIOR_SCORES_1X2[a][b][x][y][z][c][d]`` (the
  reference reads x = s[i+1], y = s[j-1], z = s[j-2]; vienna's middle index
  is s[q+1] = s[j-2] = z, utils.rs:283-293).
* ``int22[t1][t2][x1][x2][y2][y1]`` -> ``INTERIOR_SCORES_2X2[a][b][x1][y1]
  [x2][y2][c][d]`` (reference reads mismatches (s[i+1], s[j-1]) then
  (s[i+2], s[j-2]), utils.rs:306-313).
* ``Misc`` field 2 (0-based) is the terminal-AU/GU penalty; the last float
  field is ``lxc`` (hairpin length extrapolation, = 1.75*RT kcal/mol).
* ``ML_params`` = [cu, cu_dH, cc, cc_dH, ci, ci_dH]: cc -> multibranch
  base init, ci -> per-branch coefficient (the reference's Turner model has
  no per-unpaired multibranch term; cu is 0 in Turner 2004).
* Tri/Tetra/Hexaloop lines ``SEQ dG dH`` -> the special-hairpin list
  (full subsequence including the closing pair, utils.rs:198-205).
"""

import math
import re

import numpy as np

from ..constants import A, C, G, U, NUM_BASES_PAD, RT

_B = NUM_BASES_PAD

# .par pair column/row order.
PAIR_ORDER = [(C, G), (G, C), (G, U), (U, G), (A, U), (U, A)]
_BASE_FROM_CHAR = {"A": A, "C": C, "G": G, "U": U}


def _dg_score(deka):
    """dekacal/mol free energy -> dimensionless log-Boltzmann score."""
    if deka is None or math.isinf(deka):
        return np.float32(-np.inf)
    return np.float32(-(deka / 100.0) / RT)


class ParseError(ValueError):
    pass


def _tokenize_sections(text):
    """Split a .par file into {section name: [numeric-ish tokens or seq lines]}."""
    sections = {}
    cur = None
    for raw in text.splitlines():
        line = re.sub(r"/\*.*?\*/", " ", raw)  # strip inline comments
        line = line.split("//")[0]
        if not line.strip():
            continue
        if line.startswith("#"):
            cur = line[1:].strip()
            sections[cur] = []
            continue
        if cur is None:
            continue
        sections[cur].extend(line.split())
    return sections


def _numbers(tokens, section):
    out = []
    for t in tokens:
        if t in ("INF", "inf"):
            out.append(math.inf)
        elif t in ("-INF", "-inf", "NST", "DEF"):
            out.append(math.inf)
        else:
            try:
                out.append(float(t))
            except ValueError as e:
                raise ParseError(f"bad token {t!r} in section {section}") from e
    return out


def _reshape(vals, section, *dim_candidates):
    """Pick the dimension tuple whose product matches the token count."""
    for dims in dim_candidates:
        if int(np.prod(dims)) == len(vals):
            return np.array(vals, dtype=np.float64).reshape(dims)
    raise ParseError(
        f"section {section}: {len(vals)} values fit none of {dim_candidates}"
    )


def _pair_dims(count, inner):
    """Infer how many pair rows a (pairs, inner...) section carries."""
    for npairs in (6, 7, 8):
        if count == npairs * inner:
            return npairs
    raise ParseError(f"cannot infer pair count from {count} / {inner}")


def parse_vienna_par(text):
    """Parse .par text -> dict keyed like params.turner's module constants.

    Only the canonical 6 pairs and real 4 bases land in the output arrays;
    NN/N rows in the file are read and dropped.
    """
    sec = _tokenize_sections(text)
    out = {}

    def have(name):
        return name in sec and sec[name]

    # --- stack -------------------------------------------------------------
    if have("stack"):
        vals = _numbers(sec["stack"], "stack")
        npairs = int(round(math.sqrt(len(vals))))
        if npairs * npairs != len(vals):
            raise ParseError(f"stack section is not square: {len(vals)}")
        m = _reshape(vals, "stack", (npairs, npairs))
        t = np.zeros((_B, _B, _B, _B), dtype=np.float32)
        for p1, (a, b) in enumerate(PAIR_ORDER):
            for p2, (d, c) in enumerate(PAIR_ORDER):
                # t2 indexes the reversed inner pair (j-1, i+1) = (d, c)
                t[a][b][c][d] = _dg_score(m[p1][p2])
        out["STACK_SCORES"] = t

    # --- terminal mismatches -----------------------------------------------
    mm_map = {
        "mismatch_hairpin": "TERMINAL_MISMATCH_SCORES_HAIRPIN",
        "mismatch_interior": "TERMINAL_MISMATCH_SCORES_INTERIOR",
        "mismatch_interior_1n": "TERMINAL_MISMATCH_SCORES_1XMANY",
        "mismatch_interior_23": "TERMINAL_MISMATCH_SCORES_2X3",
        "mismatch_multi": "TERMINAL_MISMATCH_SCORES_MULTIBRANCH",
        # parsed for completeness; the reference model uses the multi table
        # in external contexts (utils.rs:384-411)
        "mismatch_exterior": "TERMINAL_MISMATCH_SCORES_EXTERIOR",
    }
    for name, key in mm_map.items():
        if not have(name):
            continue
        vals = _numbers(sec[name], name)
        npairs = _pair_dims(len(vals), 25)
        m = _reshape(vals, name, (npairs, 5, 5))
        t = np.zeros((_B, _B, _B, _B), dtype=np.float32)
        for p, (a, b) in enumerate(PAIR_ORDER):
            for x in range(4):
                for y in range(4):
                    t[a][b][x][y] = _dg_score(m[p][x + 1][y + 1])
        out[key] = t

    # --- dangles -------------------------------------------------------------
    for name, key in (
        ("dangle5", "DANGLING_SCORES_5PRIME"),
        ("dangle3", "DANGLING_SCORES_3PRIME"),
    ):
        if not have(name):
            continue
        vals = _numbers(sec[name], name)
        npairs = _pair_dims(len(vals), 5)
        m = _reshape(vals, name, (npairs, 5))
        t = np.zeros((_B, _B, _B), dtype=np.float32)
        for p, (a, b) in enumerate(PAIR_ORDER):
            for x in range(4):
                t[a][b][x] = _dg_score(m[p][x + 1])
        out[key] = t

    # --- small interiors -----------------------------------------------------
    if have("int11"):
        vals = _numbers(sec["int11"], "int11")
        npairs = int(round(math.sqrt(len(vals) / 25.0)))
        m = _reshape(vals, "int11", (npairs, npairs, 5, 5))
        t = np.zeros((_B,) * 6, dtype=np.float32)
        for p1, (a, b) in enumerate(PAIR_ORDER):
            for p2, (d, c) in enumerate(PAIR_ORDER):
                for x in range(4):
                    for y in range(4):
                        t[a][b][x][y][c][d] = _dg_score(m[p1][p2][x + 1][y + 1])
        out["INTERIOR_SCORES_1X1"] = t

    if have("int21"):
        vals = _numbers(sec["int21"], "int21")
        npairs = int(round((len(vals) / 125.0) ** 0.5))
        m = _reshape(vals, "int21", (npairs, npairs, 5, 5, 5))
        t = np.zeros((_B,) * 7, dtype=np.float32)
        for p1, (a, b) in enumerate(PAIR_ORDER):
            for p2, (d, c) in enumerate(PAIR_ORDER):
                for x in range(4):
                    for z in range(4):
                        for y in range(4):
                            # vienna [x][z][y]: x = s[i+1], z = s[j-2], y = s[j-1]
                            t[a][b][x][y][z][c][d] = _dg_score(
                                m[p1][p2][x + 1][z + 1][y + 1]
                            )
        out["INTERIOR_SCORES_1X2"] = t

    if have("int22"):
        vals = _numbers(sec["int22"], "int22")
        # written for real bases only; pair count may exclude NN
        npairs = int(round((len(vals) / 256.0) ** 0.5))
        m = _reshape(vals, "int22", (npairs, npairs, 4, 4, 4, 4))
        t = np.zeros((_B,) * 8, dtype=np.float32)
        for p1, (a, b) in enumerate(PAIR_ORDER):
            for p2, (d, c) in enumerate(PAIR_ORDER):
                for x1 in range(4):
                    for x2 in range(4):
                        for y2 in range(4):
                            for y1 in range(4):
                                t[a][b][x1][y1][x2][y2][c][d] = _dg_score(
                                    m[p1][p2][x1][x2][y2][y1]
                                )
        out["INTERIOR_SCORES_2X2"] = t

    # --- length initiations ---------------------------------------------------
    for name, key in (
        ("hairpin", "HAIRPIN_SCORES_INIT"),
        ("bulge", "BULGE_SCORES_INIT"),
        ("interior", "INTERIOR_SCORES_INIT"),
    ):
        if not have(name):
            continue
        vals = _numbers(sec[name], name)
        out[key] = np.array([_dg_score(v) for v in vals], dtype=np.float32)

    # --- scalars ---------------------------------------------------------------
    if have("NINIO"):
        vals = _numbers(sec["NINIO"], "NINIO")
        # [m, m_dH, max]
        out["NINIO_COEFF"] = _dg_score(vals[0])
        out["NINIO_MAX"] = _dg_score(vals[-1])
    if have("ML_params"):
        vals = _numbers(sec["ML_params"], "ML_params")
        if len(vals) != 6:
            raise ParseError(f"ML_params expects 6 values, got {len(vals)}")
        out["INIT_MULTIBRANCH_BASE"] = _dg_score(vals[2])
        out["COEFF_NUM_BRANCHES"] = _dg_score(vals[4])
    if have("Misc"):
        vals = _numbers(sec["Misc"], "Misc")
        if len(vals) >= 3:
            out["HELIX_AUGU_END_PENALTY"] = _dg_score(vals[2])
        floats = [v for v in vals if math.isfinite(v) and not float(v).is_integer()]
        if floats:
            # lxc (kcal-scale positive coeff) -> score-space negative coeff
            out["COEFF_HAIRPIN_LEN_EXTRAPOLATION"] = np.float32(
                -(floats[-1] / 100.0) / RT
            )

    # --- convention adjustment: unbake the AU/GU closure ----------------------
    # ViennaRNA's energy model adds ONLY the mismatch table inside hairpin
    # and interior loops, so the .par mismatch_hairpin / mismatch_interior*
    # rows for AU/UA/GU/UG closing pairs carry the terminal-AU/GU closure
    # penalty baked in.  The reference's scoring (and ours,
    # utils.rs:188-195,316-319 analogs) adds HELIX_AUGU_END_PENALTY
    # separately on those paths, so a raw ingest would double-count it —
    # subtract the file's own Misc terminal-AU value (the same value the
    # scoring re-adds) from those rows.  mismatch_multi/exterior need no
    # adjustment (Vienna adds the penalty separately there, as we do), and
    # int11/int21/int22 keep the baked closure (the reference reads those
    # tables without any separate penalty, utils.rs:273-304).
    pen = out.get("HELIX_AUGU_END_PENALTY")
    if pen is not None:
        wobble = ((A, U), (U, A), (G, U), (U, G))
        for key in (
            "TERMINAL_MISMATCH_SCORES_HAIRPIN",
            "TERMINAL_MISMATCH_SCORES_INTERIOR",
            "TERMINAL_MISMATCH_SCORES_1XMANY",
            "TERMINAL_MISMATCH_SCORES_2X3",
        ):
            t = out.get(key)
            if t is None:
                continue
            for (a, b) in wobble:
                # real bases only; the PSEUDO_BASE pads stay neutral
                t[a][b][:4, :4] = t[a][b][:4, :4] - np.float32(pen)

    # --- special hairpins -------------------------------------------------------
    specials = []
    for name in ("Triloops", "Tetraloops", "Hexaloops"):
        if not have(name):
            continue
        toks = sec[name]
        i = 0
        while i < len(toks):
            seq_s = toks[i]
            if not re.fullmatch(r"[ACGU]+", seq_s):
                raise ParseError(f"{name}: expected sequence, got {seq_s!r}")
            dg_v = float(toks[i + 1])
            # consume optional enthalpy column
            step = 3 if i + 2 < len(toks) and not re.fullmatch(
                r"[ACGU]+", toks[i + 2]
            ) else 2
            specials.append((seq_s, dg_v))
            i += step
    if specials:
        seqs = [[_BASE_FROM_CHAR[ch] for ch in s] for s, _ in specials]
        scores = np.array([_dg_score(v) for _, v in specials], dtype=np.float32)
        lmax = max(len(s) for s in seqs)
        arr = np.full((len(seqs), lmax), -1, dtype=np.int32)
        lens = np.array([len(s) for s in seqs], dtype=np.int32)
        for k, s in enumerate(seqs):
            arr[k, : len(s)] = s
        out["HAIRPIN_SPECIAL_SEQS"] = arr
        out["HAIRPIN_SPECIAL_LENS"] = lens
        out["HAIRPIN_SPECIAL_SCORES"] = scores

    return out


def load_turner_params(path):
    """Read a ViennaRNA .par file -> table dict (params.turner key names)."""
    with open(path) as f:
        return parse_vienna_par(f.read())
