"""Synthetic Rfam-seed-like Stockholm generator for the eval pipeline.

The reference eval consumes Rfam 14.3 seed alignments
(`reference/scripts/compile_rna_fams.py:19`), but the `.sth` asset is a
missing large blob upstream (`.MISSING_LARGE_BLOBS`).  This module
synthesizes a REPRESENTATIVE seed set so the pipeline can run end-to-end:
each family is built from a random nested
secondary-structure template, and member sequences are sampled to be
*compatible* with it (canonical pairs at paired columns, covariation across
members, point mutations and gap columns at unpaired positions).  The
generating structure is the family's reference structure, so estimator
accuracy against it is a meaningful — if easier-than-Rfam — signal, and the
filters of compile_rna_fams (<= 10 seqs, <= 200 cols, ambiguity codes) are
exercised by deliberately out-of-spec families.

Deterministic for a given seed; the committed dataset is
assets/synth_rfam_seed.sth (scripts/run_eval.py regenerates it).
"""

import numpy as np

PAIR_CHOICES = ["AU", "UA", "CG", "GC", "GU", "UG"]
PAIR_WEIGHTS = np.array([0.22, 0.22, 0.24, 0.24, 0.04, 0.04])
BASES = "ACGU"


def random_structure(rng, n):
    """Random nested dot-bracket of length n (hairpin loops >= 3)."""
    if n < 10:
        return "." * n
    r = rng.random()
    if r < 0.55:
        s = int(rng.integers(3, 8))
        s = min(s, (n - 5) // 2)
        if s < 2:
            return "." * n
        return "(" * s + random_structure(rng, n - 2 * s) + ")" * s
    if r < 0.8 and n >= 24:
        k = int(rng.integers(10, n - 10))
        return random_structure(rng, k) + random_structure(rng, n - k)
    u = int(rng.integers(1, 5))
    return "." * u + random_structure(rng, n - u)


def multiloop_structure(rng, n):
    """Multiloop-dense template: an outer stem closing >= 3 inner stems.

    A hard class: multibranch-heavy
    structures stress the multibranch affine model rather than the
    single-stem hairpins random_structure mostly emits."""
    if n < 40:
        return random_structure(rng, n)
    s = int(rng.integers(3, 6))
    inner_n = n - 2 * s
    n_branches = int(rng.integers(3, 5))
    # split the interior into branches + spacers
    spacer = int(rng.integers(1, 4))
    budget = inner_n - spacer * (n_branches + 1)
    if budget < n_branches * 12:
        return random_structure(rng, n)
    cuts = sorted(rng.choice(budget - n_branches * 12 + 1, n_branches - 1)) if n_branches > 1 else []
    sizes = []
    prev = 0
    for c in list(cuts) + [budget - n_branches * 12]:
        sizes.append(12 + (c - prev))
        prev = c
    parts = ["." * spacer]
    for sz in sizes:
        bs = min(int(rng.integers(3, 6)), (sz - 4) // 2)
        parts.append("(" * bs + "." * (sz - 2 * bs) + ")" * bs)
        parts.append("." * spacer)
    inner = "".join(parts)
    inner += "." * (inner_n - len(inner))
    return "(" * s + inner + ")" * s


def longrange_structure(rng, n):
    """Long-range template: a short outer stem pairing the two ends of the
    sequence (pair distance ~ n), enclosing mostly-local content.  Stresses
    the estimator's ability to keep probability mass on distant pairs."""
    if n < 60:
        return random_structure(rng, n)
    s = int(rng.integers(3, 5))
    inner = random_structure(rng, n - 2 * s)
    return "(" * s + inner + ")" * s


def add_pseudoknot(rng, ss):
    """Overlay a crossing stem as letter brackets (A...a) on a nested
    template.  The reference eval preserves letter brackets and projects
    them as reference pairs (compile_rna_fams.py:72-106), so a nested-only
    estimator is structurally unable to predict them — the hard class the
    hard class the eval asks for."""
    ss = list(ss)
    n = len(ss)
    # find two unpaired runs separated by a paired region
    runs = []
    start = None
    for i, ch in enumerate(ss + ["x"]):
        if ch == "." and start is None:
            start = i
        elif ch != "." and start is not None:
            if i - start >= 4:
                runs.append((start, i))
            start = None
    for (a0, a1) in runs:
        for (b0, b1) in runs:
            if b0 <= a1:
                continue
            # require a bracket between the runs so the knot crosses
            if not any(c in "()" for c in ss[a1:b0]):
                continue
            k = min(3, a1 - a0, b1 - b0)
            for t in range(k):
                ss[a0 + t] = "A"
                ss[b1 - 1 - t] = "a"
            return "".join(ss)
    return "".join(ss)


def pair_table(ss):
    """Pairs of a template incl. pseudoknot letter brackets (A/a)."""
    stack, pairs = [], []
    kstack = []
    for i, ch in enumerate(ss):
        if ch == "(":
            stack.append(i)
        elif ch == ")":
            pairs.append((stack.pop(), i))
        elif ch == "A":
            kstack.append(i)
        elif ch == "a":
            pairs.append((kstack.pop(), i))
    return pairs


def sample_family(rng, n_seqs, length, mut_rate=0.08, gap_rate=0.06,
                  structure_cls="random"):
    """(rows, ss_cons): aligned member sequences compatible with one template.

    ``structure_cls``: "random" (nested templates), "multiloop",
    "longrange", or "pseudoknot" — the hard classes."""
    if structure_cls == "multiloop":
        ss = multiloop_structure(rng, length)
    elif structure_cls == "longrange":
        ss = longrange_structure(rng, length)
    elif structure_cls == "pseudoknot":
        ss = add_pseudoknot(rng, random_structure(rng, length))
    else:
        ss = random_structure(rng, length)
    pairs = pair_table(ss)
    paired = {i for p in pairs for i in p}
    # family consensus sequence
    cols = [BASES[rng.integers(4)] for _ in range(length)]
    for i, j in pairs:
        p = PAIR_CHOICES[rng.choice(len(PAIR_CHOICES), p=PAIR_WEIGHTS)]
        cols[i], cols[j] = p[0], p[1]
    rows = []
    for s in range(n_seqs):
        seq = list(cols)
        for i, j in pairs:
            if rng.random() < mut_rate:  # covarying pair substitution
                p = PAIR_CHOICES[rng.choice(len(PAIR_CHOICES), p=PAIR_WEIGHTS)]
                seq[i], seq[j] = p[0], p[1]
        for i in range(length):
            if i not in paired:
                if rng.random() < gap_rate:
                    seq[i] = "-"
                elif rng.random() < mut_rate:
                    seq[i] = BASES[rng.integers(4)]
        rows.append((f"fam/seq{s}", "".join(seq)))
    return rows, ss


def write_stockholm(path, families):
    """families = [(rows, ss_cons)] -> one multi-alignment Stockholm file."""
    with open(path, "w") as f:
        for rows, ss in families:
            f.write("# STOCKHOLM 1.0\n")
            width = max(
                max(len(name) for name, _ in rows), len("#=GC SS_cons")
            ) + 2
            for name, seq in rows:
                f.write(f"{name:<{width}}{seq}\n")
            f.write(f"{'#=GC SS_cons':<{width}}{ss}\n//\n")


def generate_seed_set(path, n_families=20, seed=20260819):
    """Write a synthetic seed set; returns the number of VALID families.

    Families cycle through difficulty classes — the easy
    nested templates plus multiloop-dense, long-range and >= 150-nt
    families, and pseudoknotted references (letter brackets the nested-only
    estimators cannot predict) — so the accuracy gate tests discrimination,
    not just plumbing.  Includes out-of-spec families (too many members,
    too wide, ambiguity codes) so compile_rna_fams' filters are exercised
    on realistic input.
    """
    rng = np.random.default_rng(seed)
    fams = []
    valid = 0
    classes = ("random", "multiloop", "longrange", "pseudoknot", "random")
    for k in range(n_families):
        cls = classes[k % len(classes)]
        if cls in ("multiloop", "longrange"):
            length = int(rng.integers(150, 200))  # the >= 150-nt hard class
        else:
            length = int(rng.integers(60, 190))
        n_seqs = int(rng.integers(3, 10))
        fams.append(sample_family(rng, n_seqs, length, structure_cls=cls))
        valid += 1
    # out-of-spec: too many sequences
    fams.append(sample_family(rng, 14, 80))
    # out-of-spec: too wide
    fams.append(sample_family(rng, 4, 240))
    # out-of-spec: ambiguity code
    rows, ss = sample_family(rng, 4, 70)
    rows = [(n, s.replace("A", "N", 1)) for n, s in rows]
    fams.append((rows, ss))
    write_stockholm(path, fams)
    return valid
