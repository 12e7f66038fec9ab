"""Rfam seed-alignment dataset compilation.

Re-creation of `reference/scripts/compile_rna_fams.py`: filter Rfam seed
Stockholm alignments (<= 10 seqs, <= 200 columns, no ambiguity codes), project
the consensus structure onto each ungapped sequence (preserving pseudoknot
letter brackets), and emit per-family sequence + reference-structure FASTA
files.  Uses a self-contained Stockholm parser (no BioPython dependency).
"""

import os

# compile_rna_fams.py:15 — note: no <>, {}, [] here; those are normalized first
BRACKET_PAIRS = [
    ("(", ")"), ("A", "a"), ("B", "b"), ("C", "c"), ("D", "d"), ("E", "e"),
]
AMBIGUITY = set("RYWSMKHBVDN")


def parse_stockholm(path):
    """Yield (rows, ss_cons) per alignment: rows = [(id, aligned_seq)]."""
    rows = {}
    order = []
    ss = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("# STOCKHOLM"):
                rows, order, ss = {}, [], []
            elif line.startswith("#=GC SS_cons"):
                ss.append(line.split(None, 2)[2])
            elif line.startswith("#") or not line.strip():
                continue
            elif line.strip() == "//":
                if rows:
                    yield [(i, rows[i]) for i in order], "".join(ss)
                rows, order, ss = {}, [], []
            else:
                parts = line.split(None, 1)
                if len(parts) != 2:
                    continue
                name, seq = parts
                if name not in rows:
                    rows[name] = ""
                    order.append(name)
                rows[name] += seq.replace(".", "-").replace("_", "-").replace("~", "-")


def convert_css(css):
    """Normalize the consensus structure (compile_rna_fams.py:72-84)."""
    out = []
    for ch in css:
        if ch in "(<[{":
            out.append("(")
        elif ch in ")>]}":
            out.append(")")
        elif ch in "ABCDEabcde":
            out.append(ch)
        else:
            out.append(".")
    return "".join(out)


def recover_ss(css, seq_with_gaps):
    """Project consensus structure onto one ungapped sequence
    (compile_rna_fams.py:85-106)."""
    pos_map = {}
    pos = 0
    for i, ch in enumerate(seq_with_gaps):
        if ch != "-":
            pos_map[i] = pos
            pos += 1
    rec = ["."] * pos
    for left, right in BRACKET_PAIRS:
        stack = []
        for i, ch in enumerate(css):
            if ch == left:
                stack.append(i)
            elif ch == right:
                j = stack.pop()
                if seq_with_gaps[j] == "-" or seq_with_gaps[i] == "-":
                    continue
                rec[pos_map[j]] = left
                rec[pos_map[i]] = right
    return "".join(rec)


def is_valid(rows):
    return not any(
        ch in AMBIGUITY for _, seq in rows for ch in seq
    )


def compile_rna_fams(sth_path, seq_dir, ss_dir, max_sa_len=200, max_seq_num=10):
    """Per-family FASTA + reference structures (compile_rna_fams.py:17-64).

    Returns the number of compiled families.
    """
    os.makedirs(seq_dir, exist_ok=True)
    os.makedirs(ss_dir, exist_ok=True)
    count = 0
    for rows, ss_cons in parse_stockholm(sth_path):
        if not rows or not ss_cons:
            continue
        if len(rows) > max_seq_num or len(rows[0][1]) > max_sa_len:
            continue
        if not is_valid(rows):
            continue
        css = convert_css(ss_cons)
        seq_path = os.path.join(seq_dir, f"rna_fam_{count}.fa")
        ss_path = os.path.join(ss_dir, f"rna_fam_{count}.fa")
        with open(seq_path, "w") as sf, open(ss_path, "w") as rf:
            for j, (rid, aligned) in enumerate(rows):
                seq = aligned.replace("-", "")
                sf.write(f">{j}({rid})\n{seq.upper().replace('T', 'U')}\n")
                rf.write(f">{j}({rid})\n{recover_ss(css, aligned)}\n")
        count += 1
    return count
