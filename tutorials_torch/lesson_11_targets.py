"""Lesson 11: targets and feature flags -- the cross-compilation analog
(reference: tutorial/lesson_11_cross_compilation.cpp).

The reference compiles object files for foreign architectures. Here the
architecture is the card's (sm_90a), so the Target carries FEATURES that
change lowering/behavior instead: `no_pallas` (evaluate every tiled group
whole-array with torch instead of the GPU kernel K1), `interpret` (the
same), `trace_all`, `profile`. Targets parse from strings exactly like
the reference's `host-feature1-feature2`, and HL_JIT_TARGET in the
environment overrides the default.
"""
import numpy as np
import halide_tpu_torch as hl
from halide_tpu_torch.target import Target, get_host_target


def main(device=None):
    host = get_host_target()
    print("host target:", host)

    t = Target("host-no_pallas-trace_all")
    assert t.has_feature("no_pallas") and t.has_feature("trace_all")
    assert not t.has_feature("profile")

    # the same pipeline realized under different targets
    x, y = hl.Var("x"), hl.Var("y")
    xo, yo, xi, yi = (hl.Var(n) for n in "xo yo xi yi".split())
    f = hl.Func("l11_f")
    g = hl.Func("l11_g")
    f[x, y] = x * 3 + y
    g[x, y] = f[x, y] + 1
    g.tile(x, y, xo, yo, xi, yi, 32, 16)
    f.compute_at(g, xo)

    want = (np.arange(96)[None, :] * 3 + np.arange(48)[:, None]) + 1

    # default: the tiled group lowers to the GPU kernel K1
    out_default = g.realize([96, 48], device=device).to_numpy()
    np.testing.assert_array_equal(out_default, want)

    # no_pallas: identical VALUES through whole-array torch ops --
    # features change lowering, never semantics
    out_whole = g.realize([96, 48], target=Target("host-no_pallas"),
                          device=device).to_numpy()
    np.testing.assert_array_equal(out_whole, want)
    print("lesson 11: feature-gated lowerings agree")


if __name__ == "__main__":
    main()
