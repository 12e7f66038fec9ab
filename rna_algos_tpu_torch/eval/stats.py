"""Accuracy statistics for secondary-structure estimation.

Re-creation of `reference/scripts/get_stats_of_ss_estimation_programs.py`
(:154-197) and `scripts/utils.py:get_sss` (:18-33): multi-bracket dot-bracket
parsing (incl. pseudoknot letter pairs), TP/TN/FP/FN counting over all i<j
position pairs, and PPV / sensitivity / FPR / F1 / MCC.
"""

from math import sqrt

# utils.py:8 — bracket alphabets, incl. pseudoknot letters
BRACKET_PAIRS = [
    ("(", ")"), ("<", ">"), ("{", "}"), ("[", "]"),
    ("A", "a"), ("B", "b"), ("C", "c"), ("D", "d"), ("E", "e"),
]


def parse_ss_string(ss):
    """Set of (i, j) pairs from a (possibly pseudoknotted) structure string."""
    pairs = set()
    for left, right in BRACKET_PAIRS:
        stack = []
        for j, ch in enumerate(ss):
            if ch == left:
                stack.append(j)
            elif ch == right:
                pairs.add((stack.pop(), j))
    return pairs


def read_sss(path):
    """Structures from a FASTA-of-dot-brackets file (utils.py:get_sss)."""
    sss = []
    cur = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if cur:
                    sss.append(parse_ss_string("".join(cur)))
                    cur = []
                sss.append(None)  # placeholder marks record start
                sss.pop()
                cur = []
            else:
                cur.append(line)
        if cur:
            sss.append(parse_ss_string("".join(cur)))
    return sss


def pos_neg_counts(estimated_sss, ref_sss, seq_lens):
    """(tp, tn, fp, fn) over all i<j pairs (get_stats...py:154-173)."""
    tp = tn = fp = fn = 0
    for est, ref, n in zip(estimated_sss, ref_sss, seq_lens):
        n_pairs = n * (n - 1) // 2
        est = {p for p in est if 0 <= p[0] < p[1] < n}
        ref = {p for p in ref if 0 <= p[0] < p[1] < n}
        tp_ = len(est & ref)
        fp_ = len(est - ref)
        fn_ = len(ref - est)
        tp += tp_
        fp += fp_
        fn += fn_
        tn += n_pairs - tp_ - fp_ - fn_
    return tp, tn, fp, fn


def final_sum(results):
    tp = tn = fp = fn = 0.0
    for a, b, c, d in results:
        tp += a
        tn += b
        fp += c
        fn += d
    return tp, tn, fp, fn


def get_ppv(tp, fp):
    return tp / (tp + fp)


def get_sens(tp, fn):
    return tp / (tp + fn)


def get_fpr(tn, fp):
    return fp / (tn + fp)


def get_f1_score(ppv, sens):
    return 2 * ppv * sens / (ppv + sens)


def get_mcc(tp, tn, fp, fn):
    return (tp * tn - fp * fn) / sqrt(
        (tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)
    )


def summarize(tp, tn, fp, fn):
    """All five metrics; degenerate (zero-denominator) cases map to nan
    (the reference would divide by zero there — it never hits them on the
    real Rfam data, but the toy tests do)."""

    def safe(f, *args):
        try:
            return f(*args)
        except ZeroDivisionError:
            return float("nan")

    ppv = safe(get_ppv, tp, fp)
    sens = safe(get_sens, tp, fn)
    return {
        "ppv": ppv,
        "sens": sens,
        "fpr": safe(get_fpr, tn, fp),
        "f1": safe(get_f1_score, ppv, sens),
        "mcc": safe(get_mcc, tp, tn, fp, fn),
    }
