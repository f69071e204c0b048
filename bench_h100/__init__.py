"""The frame-time benchmark of halide_tpu_torch on one NVIDIA H100.

    python3 -m bench_h100.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` at the repository's root names every cell, configuration
and metric; this package finds each by that name: a configuration in
`configs/<name>.json` with its plain reference in `reference/<name>.py`, a
traffic mix in `traffic/<name>.json`, a per-layer metric's reader in
`metrics/<name>.py`, an input kind in `inputs/<kind>.py` and a comparison in
`compare/<kind>.py`. Nothing here imports JAX or the JAX package.
"""
