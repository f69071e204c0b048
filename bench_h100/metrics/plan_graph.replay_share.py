"""Whole-array stages: the share of the window's realizes that replayed
their plan's CUDA graph (a realize record with an `ht.replay` span) in
place of evaluating the stages one launch at a time, in percent (read from
the port's ring of realize records)."""


def read(rec):
    try:
        from halide_tpu_torch import spans
    except ImportError:         # a port without spans
        return None
    if "ht.replay" not in spans.KINDS:      # a port that replays nothing
        return None
    recs = spans.within([(int(s.call * 1e9), int(s.ret * 1e9))
                         for s in rec["spans"]]) if rec["spans"] else None
    if not recs:
        return None
    return 100.0 * sum(r["spans"]["ht.replay"]["count"] >= 1
                       for r in recs) / len(recs)
