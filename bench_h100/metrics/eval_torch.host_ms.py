"""Whole-array stages: the mean host time a realize of evaluating the
whole-array stages (the port's `ht.stage` spans, one a stage evaluated:
the expression trees walked, torch's calls made), over the window's frames
(host clock, read from the port's ring of realize records)."""


def read(rec):
    try:
        from halide_tpu_torch import spans
    except ImportError:         # a port without spans
        return None
    recs = spans.within([(int(s.call * 1e9), int(s.ret * 1e9))
                         for s in rec["spans"]]) if rec["spans"] else None
    if not recs:
        return None
    return sum(r["spans"]["ht.stage"]["total_ns"] for r in recs) \
        * 1e-6 / len(recs)
