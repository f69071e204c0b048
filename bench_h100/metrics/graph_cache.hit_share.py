"""Front end and planning: the share of the window's realizes whose
`Pipeline._prepare` reused its last graph walk (a realize record with an
`ht.graph_reuse` span) in place of walking every definition again, in
percent (read from the port's ring of realize records)."""


def read(rec):
    try:
        from halide_tpu_torch import spans
    except ImportError:         # a port without spans
        return None
    if "ht.graph_reuse" not in spans.KINDS:     # a port that walks each time
        return None
    recs = spans.within([(int(s.call * 1e9), int(s.ret * 1e9))
                         for s in rec["spans"]]) if rec["spans"] else None
    if not recs:
        return None
    return 100.0 * sum(r["spans"]["ht.graph_reuse"]["count"] >= 1
                       for r in recs) / len(recs)
