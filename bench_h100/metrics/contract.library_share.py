"""Contraction paths: the share of the contractions lowered since the
process started that took a library path, the convolution (cuDNN) or the
einsum (cuBLAS), against the unrolled and the dense lowering, in percent
(the port's counters contract.*, counted on eager realizes)."""

PATHS = ("contract.conv", "contract.einsum", "contract.unrolled",
         "contract.dense")


def read(rec):
    try:
        from halide_tpu_torch import spans
    except ImportError:         # a port without spans
        return None
    c = spans.counters()
    if any(k not in c for k in PATHS):      # a port without the counters
        return None
    total = sum(c[k] for k in PATHS)
    if not total:
        return None
    return 100.0 * (c["contract.conv"] + c["contract.einsum"]) / total
