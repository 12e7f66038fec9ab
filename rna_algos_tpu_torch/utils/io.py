"""Sequence / alignment I/O.

Re-creation of the reference's I/O surface (SURVEY C18): FASTA reading
(bin/*:50-56), strict ACGU encoding (`bytes2seq`, utils.rs:562-577), permissive
alignment encoding (`align_char2base`, utils.rs:746-754), and the Clustal / aligned
FASTA / Stockholm alignment readers (utils.rs:657-744) consumed by downstream
packages.
"""

from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..constants import CHAR2BASE, PSEUDO_BASE


@dataclass
class FastaRecord:
    """A FASTA record with an integer-encoded sequence (utils.rs:50-54)."""

    fasta_id: str
    seq: np.ndarray  # int32 base codes


@dataclass
class Align:
    """Alignment columns + per-sequence position maps (utils.rs:56-59)."""

    cols: List[List[int]] = field(default_factory=list)
    pos_map_sets: List[List[int]] = field(default_factory=list)


def bytes2seq(s) -> np.ndarray:
    """Strict ACGU/acgu encoding; anything else is an error (utils.rs:562-577)."""
    if isinstance(s, (bytes, bytearray)):
        s = s.decode()
    try:
        return np.array([CHAR2BASE[ch] for ch in s], dtype=np.int32)
    except KeyError as e:
        raise ValueError(f"invalid RNA character: {e.args[0]!r}") from None


def align_char2base(ch: str) -> int:
    """ACGU/acgu -> base, everything else -> PSEUDO_BASE (utils.rs:746-754)."""
    return CHAR2BASE.get(ch, PSEUDO_BASE)


_BASE2CHAR = "ACGU" + "N"


def seq2str(seq) -> str:
    return "".join(_BASE2CHAR[int(b)] for b in seq)


def read_fasta(path) -> List[FastaRecord]:
    """Read a FASTA file; record id is the first whitespace-delimited token.

    Fail-fast with record context on malformed sequences (the reference
    panics without context, utils.rs:570-572; SURVEY §5 failure detection).
    """
    records = []
    cur_id = None
    cur_seq: List[str] = []

    def flush():
        try:
            records.append(FastaRecord(cur_id, bytes2seq("".join(cur_seq))))
        except ValueError as e:
            raise ValueError(
                f"{path}: record {len(records)} ({cur_id!r}): {e}"
            ) from None

    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if cur_id is not None:
                    flush()
                cur_id = line[1:].split()[0] if len(line) > 1 else ""
                cur_seq = []
            else:
                cur_seq.append(line)
    if cur_id is not None:
        flush()
    return records


def read_align_clustal(path):
    """Clustal reader (utils.rs:657-692): returns (cols, seq_ids)."""
    cols: List[List[int]] = []
    seq_ids: List[str] = []
    seq_pointer = 0
    pos_pointer = 0
    has_read_seq_ids = False
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.rstrip("\n")
            if i == 0 or not line or line.startswith(" "):
                if cols:
                    seq_pointer = 0
                    pos_pointer = len(cols)
                    has_read_seq_ids = True
                continue
            fields = line.split()
            if not has_read_seq_ids:
                seq_ids.append(fields[0])
            chunk = fields[1]
            if seq_pointer == 0:
                for ch in chunk:
                    cols.append([align_char2base(ch)])
                seq_pointer += 1
            else:
                for j, ch in enumerate(chunk):
                    cols[pos_pointer + j].append(align_char2base(ch))
    return cols, seq_ids


def read_align_fasta(path):
    """Aligned-FASTA reader (utils.rs:694-717): returns (cols, seq_ids)."""
    seqs: List[List[int]] = []
    seq_ids: List[str] = []
    with open(path) as f:
        content = f.read()
    for i, split in enumerate(content.split(">")):
        if i == 0:
            continue
        fields = split.split()
        seq_ids.append(fields[0])
        seq = "".join(fields[1:])
        seqs.append([align_char2base(ch) for ch in seq])
    align_len = len(seqs[0])
    cols = [[s[i] for s in seqs] for i in range(align_len)]
    return cols, seq_ids


def read_align_stockholm(path):
    """Stockholm reader (utils.rs:719-744): returns (cols, seq_ids)."""
    seqs: List[List[int]] = []
    seq_ids: List[str] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            if line.startswith("//"):
                break
            fields = line.split()
            seq_ids.append(fields[0])
            seqs.append([align_char2base(ch) for ch in fields[1]])
    align_len = len(seqs[0])
    cols = [[s[i] for s in seqs] for i in range(align_len)]
    return cols, seq_ids


def align_from_cols(cols):
    """Build an Align (cols + per-sequence ungapped position maps).

    The reference readers return (cols, seq_ids) and downstream consumers
    (heartsh's consprob/consalign family) assemble `Align` with
    ``pos_map_sets`` mapping each column to the ungapped sequence position
    (utils.rs:56-59); this helper provides that assembly.  Gap columns
    (PSEUDO_BASE) carry the last preceding position.
    """
    n_seqs = len(cols[0]) if cols else 0
    pos_map_sets = [[] for _ in range(n_seqs)]
    counters = [0] * n_seqs
    for col in cols:
        for s, base in enumerate(col):
            if base != PSEUDO_BASE:
                counters[s] += 1
            pos_map_sets[s].append(counters[s])
    return Align(cols=[list(c) for c in cols], pos_map_sets=pos_map_sets)
