"""Target descriptions (reference: src/Target.h:85-208, src/Target.cpp).

A Target here is `cuda-<generation>[-feature...]`, e.g. "cuda-sm_90", or
`cpu`. `host` resolves to the attached card when torch sees one whose
compute capability is 9.0 (Hopper), else to the CPU. Env vars HL_TARGET /
HL_JIT_TARGET are honored like the reference.

The target describes what is attached; it does not pick the device a realize
runs on (Pipeline.realize's `device` does that). The features are the JAX
package's names, and Pipeline.realize reads three of them as it does:
`trace_all` arms a trace on every Func, `no_pallas` and `interpret` keep the
stencil-group kernel out (every group runs whole-array), and `profile`
prints the pipeline's profile after the realize. The others are accepted
and recorded. `megacore` (the TPU's two-core grid split) has no meaning on
this card and is rejected.
"""
from __future__ import annotations

import os
from typing import FrozenSet, Optional

__all__ = ["Target", "get_host_target", "get_jit_target_from_environment",
           "get_target_from_environment", "FITTED_COST",
           "fitted_cost_params"]

_KNOWN_ARCH = {"cuda", "cpu", "host"}
_KNOWN_GEN = {"sm_90", "generic"}
_KNOWN_FEATURES: FrozenSet[str] = frozenset({
    "profile", "trace_all", "trace_loads", "trace_stores",
    "trace_realizations", "debug", "no_asserts", "interpret",
    "no_pallas", "strict_float", "jit",
})
_TPU_FEATURES = {"megacore"}


class Target:
    def __init__(self, spec: Optional[str] = None, arch: str = "host",
                 generation: str = "generic",
                 features: Optional[FrozenSet[str]] = None):
        self.arch = arch
        self.generation = generation
        self.features = set(features or ())
        if spec:
            self._parse(spec)
        if self.arch == "host":
            t = get_host_target()
            self.arch = t.arch
            if self.generation == "generic":
                self.generation = t.generation

    def _parse(self, spec: str):
        parts = spec.split("-")
        for i, p in enumerate(parts):
            if i == 0 and p in _KNOWN_ARCH:
                self.arch = p
                continue
            if p in _KNOWN_GEN:
                self.generation = p
                continue
            if p in _KNOWN_FEATURES:
                self.features.add(p)
                continue
            if p in _TPU_FEATURES:
                raise ValueError(f"target feature {p!r} in {spec!r} is a "
                                 "TPU feature; a CUDA target has none")
            raise ValueError(f"unknown target component {p!r} in {spec!r}")

    def has_feature(self, f: str) -> bool:
        return f in self.features

    def with_feature(self, f: str) -> "Target":
        return Target(arch=self.arch, generation=self.generation,
                      features=frozenset(self.features | {f}))

    def without_feature(self, f: str) -> "Target":
        return Target(arch=self.arch, generation=self.generation,
                      features=frozenset(self.features - {f}))

    def __str__(self):
        parts = [self.arch, self.generation] + sorted(self.features)
        return "-".join(parts)

    def __repr__(self):
        return f"Target({str(self)!r})"

    def __eq__(self, o):
        return (isinstance(o, Target) and self.arch == o.arch
                and self.generation == o.generation
                and self.features == o.features)

    def __hash__(self):
        return hash((self.arch, self.generation, frozenset(self.features)))


_host_cache = None


def get_host_target() -> Target:
    global _host_cache
    if _host_cache is None:
        import torch
        arch, gen = "cpu", "generic"
        if torch.cuda.is_available():
            arch = "cuda"
            if torch.cuda.get_device_capability(0) == (9, 0):
                gen = "sm_90"
        _host_cache = Target(arch=arch, generation=gen)
    return Target(arch=_host_cache.arch, generation=_host_cache.generation)


# ---------------------------------------------------------------------------
# Fitted autoscheduler cost-model coefficients, per card generation (the
# reference trains its cost model against measured runtimes,
# adams2019/DefaultCostModel.cpp:180; here the three terms of the analytical
# model are measured instead).
# `python -m halide_tpu_torch.tools.fitcost` measures on the card (a) the
# device-memory rate of a triad, (b) the f32 rate of a multiply-add chain
# inside the stencil-group kernel K1 (a tiled one-stage group whose body is
# the chain: where an inlined Func runs under the tiled schedules the
# autoscheduler writes), and (c) the slowdown of a pass that reads a
# producer at stride 2 on both x and y, fused (inlined) against split
# (compute_root), through the DSL. `ops_per_byte` is (b) over (a).
# `smem_budget` is the shared memory one K1 block may take, as K1's planner
# reckons it (group_kernel._SMEM_LIMIT). One row: a generation not listed
# (and the CPU) takes the sm_90 row, the one card measured.
# ---------------------------------------------------------------------------
FITTED_COST = {
    # tools/fitcost.py on an NVIDIA H100 80GB HBM3, power limit 700.00 W,
    # 2026-10-17 (torch 2.11.0+cu128): triad 2834 GB/s; K1 chain 0.0617 ->
    # 0.1760 ms for 16 -> 128 multiply-adds a point at 4096x4096, 32.89 T
    # f32 ops/s; dual-strided fused 0.2250 ms against split 0.1376 ms
    "sm_90": {"ops_per_byte": 11.6, "strided_penalty": 1.6,
              "smem_budget": 227 * 1024},
}


def fitted_cost_params(generation: str = None) -> dict:
    """Cost-model coefficients for the host (or named) generation, with the
    JAX package's env overrides for calibration runs
    (HT_COST_OPS_PER_BYTE, HT_COST_STRIDED_PENALTY, HT_COST_VMEM_BUDGET;
    the last sets the shared-memory budget here)."""
    gen = generation or get_host_target().generation
    p = dict(FITTED_COST.get(gen, FITTED_COST["sm_90"]))
    for key, env in (("ops_per_byte", "HT_COST_OPS_PER_BYTE"),
                     ("strided_penalty", "HT_COST_STRIDED_PENALTY"),
                     ("smem_budget", "HT_COST_VMEM_BUDGET")):
        v = os.environ.get(env)
        if v:
            p[key] = float(v)
    return p


def get_target_from_environment() -> Target:
    s = os.environ.get("HL_TARGET", "host")
    return Target(s if s != "host" else None)


def get_jit_target_from_environment() -> Target:
    s = os.environ.get("HL_JIT_TARGET", os.environ.get("HL_TARGET", "host"))
    return Target(s if s != "host" else None)
