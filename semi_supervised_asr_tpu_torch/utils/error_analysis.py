"""Alignment-level error analysis: S/I/D breakdown + confusion pairs.

The PyTorch port's copy of ``semi_supervised_asr_tpu/utils/
error_analysis.py`` (its report functions; the standalone re-analysis CLI
stays in the JAX package).  The Kaldi ``wer_details``-style report,
computed on the host from the decode records ``Solver.test`` produces:
substitutions vs deletions vs insertions, the dominant confusion pairs and
the worst utterances.

Units match the headline metric exactly: phone units fold 61->39 with
the SAME map the PER uses (utils/metrics.timit_39_id_map) before
aligning; char units analyze at the word level (the WER units).
``Solver.test(..., out_path=...)`` writes ``<out_path>.analysis.json``
beside the hypotheses and logs :func:`summary_line`.
"""

from __future__ import annotations

from collections import Counter


def align(ref: list, hyp: list) -> list[tuple[str, object, object]]:
    """Levenshtein alignment -> [(op, ref_tok|None, hyp_tok|None)].

    ops: "eq", "sub", "del" (ref token missing from hyp), "ins" (hyp
    token not in ref).  The backtrace prefers eq > sub > del > ins at
    each step (walking from the sequence ends), so among the minimal
    alignments ONE is chosen deterministically — counts are stable
    across runs, and total non-eq ops == the edit distance.
    """
    n, m = len(ref), len(hyp)
    # dp[i][j] = distance between ref[:i] and hyp[:j]
    dp = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(1, n + 1):
        dp[i][0] = i
    for j in range(1, m + 1):
        dp[0][j] = j
    for i in range(1, n + 1):
        ri = ref[i - 1]
        row, prev = dp[i], dp[i - 1]
        for j in range(1, m + 1):
            s = prev[j - 1] + (ri != hyp[j - 1])
            d = prev[j] + 1
            ins = row[j - 1] + 1
            row[j] = s if s <= d and s <= ins else (d if d <= ins else ins)
    out = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i][j] == dp[i - 1][j - 1] \
                and ref[i - 1] == hyp[j - 1]:
            out.append(("eq", ref[i - 1], hyp[j - 1]))
            i, j = i - 1, j - 1
        elif i > 0 and j > 0 and dp[i][j] == dp[i - 1][j - 1] + 1:
            out.append(("sub", ref[i - 1], hyp[j - 1]))
            i, j = i - 1, j - 1
        elif i > 0 and dp[i][j] == dp[i - 1][j] + 1:
            out.append(("del", ref[i - 1], None))
            i -= 1
        else:
            out.append(("ins", None, hyp[j - 1]))
            j -= 1
    out.reverse()
    return out


def analyze_pairs(
    pairs: list[tuple[list, list]], top: int = 20
) -> dict:
    """[(ref_tokens, hyp_tokens)] -> summary dict.

    counts: eq/sub/del/ins totals; rates normalize by total ref tokens
    (so sub_rate + del_rate + ins_rate == the error rate the headline
    metric reports, up to alignment-path ties).
    """
    ops = Counter()
    confusions: Counter = Counter()   # (ref, hyp) for subs
    deletions: Counter = Counter()
    insertions: Counter = Counter()
    n_ref = 0
    for ref, hyp in pairs:
        n_ref += len(ref)
        for op, r, h in align(ref, hyp):
            ops[op] += 1
            if op == "sub":
                confusions[(r, h)] += 1
            elif op == "del":
                deletions[r] += 1
            elif op == "ins":
                insertions[h] += 1
    n = max(n_ref, 1)
    return {
        "ref_tokens": n_ref,
        "eq": ops["eq"], "sub": ops["sub"],
        "del": ops["del"], "ins": ops["ins"],
        "sub_rate": round(ops["sub"] / n, 4),
        "del_rate": round(ops["del"] / n, 4),
        "ins_rate": round(ops["ins"] / n, 4),
        "error_rate": round((ops["sub"] + ops["del"] + ops["ins"]) / n, 4),
        "top_confusions": [
            {"ref": r, "hyp": h, "count": c}
            for (r, h), c in confusions.most_common(top)
        ],
        "top_deletions": [
            {"token": t, "count": c}
            for t, c in deletions.most_common(top)
        ],
        "top_insertions": [
            {"token": t, "count": c}
            for t, c in insertions.most_common(top)
        ],
    }


def _phone_fold_map(vocab) -> dict:
    """name -> 39-class name (None = deleted in scoring), derived from
    the SAME id table utils/metrics.per_batch folds with (the table maps
    vocab ids to TIMIT_39 class indices)."""
    from semi_supervised_asr_tpu_torch.data.vocab import TIMIT_39, timit_39_id_map

    table = timit_39_id_map(vocab)
    out = {}
    for i, tok in enumerate(vocab.tokens):
        f = int(table[i])
        out[tok] = TIMIT_39[f] if f >= 0 else None
    return out


def _record_pairs(records: list, vocab, unit: str):
    """Decode records -> token pairs in the HEADLINE metric's units."""
    pairs = []
    if unit == "phone" and vocab is not None:
        fold = _phone_fold_map(vocab)

        def toks(text):
            return [f for u in text.split()
                    if (f := fold.get(u, u)) is not None]
    else:
        def toks(text):
            return text.split()
    for rec in records:
        pairs.append((toks(rec["ref"]), toks(rec["hyp"])))
    return pairs


def analyze_records(
    records: list, vocab=None, unit: str = "char", top: int = 20,
    worst: int = 10,
) -> dict:
    """Solver decode records -> full analysis report."""
    out = analyze_pairs(_record_pairs(records, vocab, unit), top=top)
    out["unit"] = "phone39" if unit == "phone" else "word"
    out["n_utts"] = len(records)
    ranked = sorted(
        records,
        key=lambda r: r["errors"] / max(r["ref_len"], 1),
        reverse=True,
    )[:worst]
    out["worst_utts"] = [
        {"uid": r["uid"],
         "rate": round(r["errors"] / max(r["ref_len"], 1), 3),
         "ref": r["ref"], "hyp": r["hyp"]}
        for r in ranked
    ]
    return out


def summary_line(a: dict) -> str:
    parts = [f"{a['unit']} errors: sub {a['sub_rate']:.1%} "
             f"del {a['del_rate']:.1%} ins {a['ins_rate']:.1%}"]
    if a["top_confusions"]:
        c = a["top_confusions"][0]
        parts.append(
            f"top confusion {c['ref']!r}->{c['hyp']!r} x{c['count']}"
        )
    return "; ".join(parts)
