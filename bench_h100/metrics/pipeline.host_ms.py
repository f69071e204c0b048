"""Front end and planning: the mean host time of `Pipeline.realize` until it
returns, without a synchronize, over the window's frames (host clock)."""


def read(rec):
    spans = rec["spans"]
    if not spans:
        return None
    return sum(s.ret - s.call for s in spans) * 1e3 / len(spans)
