"""Lesson 4: debugging with print_when and value tracing
(reference: tutorial/lesson_04_debugging_2.cpp).

The reference injects printf calls into the generated loops. Here the
pipeline is an array program, so the analogs are:

  * hl.print_when(cond, val, ...) -- an identity on `val` that streams a
    message through the print handler when `cond` holds anywhere in the
    realized region (the values are read back to the host to decide);
  * Func.trace_stores() / trace_realizations() + tracing(...) -- emit
    HTRC packets per realization (see lesson 27 for rendering them).
"""
import numpy as np
import halide_tpu_torch as hl


def main(device=None):
    x, y = hl.Var("x"), hl.Var("y")

    # -- print_when: flag suspicious values without changing semantics --
    f = hl.Func("l04_f")
    val = hl.sin(hl.f32(x) * 0.3) * hl.cos(hl.f32(y) * 0.7)
    # wraps `val`: same number out, but logs when the predicate fires
    f[x, y] = hl.print_when(val < -0.99, val, "near -1 at", x, y)
    out = f.realize([64, 64], device=device).to_numpy()
    assert out.shape == (64, 64)

    # -- tracing: counts of realizations/stores per func ----------------
    from halide_tpu_torch.trace import tracing
    prod = hl.Func("l04_prod")
    cons = hl.Func("l04_cons")
    prod[x, y] = x + y
    prod.compute_root().trace_stores().trace_realizations()
    cons[x, y] = prod[x, y] * 2
    pipe = hl.Pipeline(cons)
    with tracing(pipe) as t:
        pipe.realize([32, 32], device=device).to_numpy()
    counts = t.counts()
    assert counts[("begin_realization", "l04_prod")] == 1
    assert counts[("store", "l04_prod")] == 1
    print("lesson 04: print_when + tracing OK;",
          "trace events:", dict(counts))


if __name__ == "__main__":
    main()
