"""Whole-array stages: the share of the stages computed on eager realizes
since the process started that the stage kernel computed (one emitted
kernel each), against those it left to eval_torch on the card, in percent
(the port's counters stage_kernel.fused and stage_kernel.declined). A
replayed frame runs no stage's Python: the counters hold the planning
realize, the warm-up and the hits before the capture."""

NAMES = ("stage_kernel.fused", "stage_kernel.declined")


def read(rec):
    try:
        from halide_tpu_torch import spans
    except ImportError:         # a port without spans
        return None
    c = spans.counters()
    if any(k not in c for k in NAMES):      # a port without the counters
        return None
    total = c["stage_kernel.fused"] + c["stage_kernel.declined"]
    if not total:
        return None
    return 100.0 * c["stage_kernel.fused"] / total
