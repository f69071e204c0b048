"""The NVIDIA H100 SXM's published peaks (data sheet, dense rates), which
every roofline and peak share of this benchmark is taken against. They
assume the card's full power limit of 700 W; each run prints the card's
`power.limit` beside its shares."""

HBM_BYTES_PER_S = 3.35e12          # 80 GB of HBM3
# float32 outside the tensor cores, a fused multiply-add counted as two
# operations; the work counts count an add and a multiply as one each
F32_OPS_PER_S = 67e12
# 32-bit integer operations: 64 INT32 lanes an SM x 132 SMs x 1.98 GHz
# boost clock (the data sheet gives no integer rate outside the tensor
# cores; this is that arithmetic)
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# the L2 cache: 50 MB, 50 MiB as the card reports it
L2_BYTES = 50 * 2 ** 20
