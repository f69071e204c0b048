"""Set-up of the port: the host time a plan-cache miss takes to plan (the
port's `ht.plan_build`, `ht.bounds` and `ht.k1.plan` spans since the
process started: the executor made, the bounds pass, K1's plans and
sources emitted; nvcc is not in it) over the plan cache's misses (host
clock, read from the port's span totals and counters)."""

KINDS = ("ht.plan_build", "ht.bounds", "ht.k1.plan")


def read(rec):
    try:
        from halide_tpu_torch import spans
    except ImportError:         # a port without spans
        return None
    misses = spans.counters()["plan_cache.misses"]
    if not misses:
        return None
    totals = spans.totals()
    return sum(totals[k]["total_ns"] for k in KINDS) * 1e-6 / misses
