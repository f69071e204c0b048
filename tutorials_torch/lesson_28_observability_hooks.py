"""Lesson 28: runtime observability -- custom print/error handlers,
require(), and debug_to_file (reference: JITUserContext custom handlers
@ HalideRuntime.h:178-196; DebugToFile.cpp)."""
import os
import tempfile

import numpy as np

import halide_tpu_torch as hl


def main(device=None):
    x = hl.Var("x")

    # 1. print() streams a per-realization value summary through the
    # installed handler (stdout by default)
    msgs = []
    prev = hl.set_custom_print(msgs.append)
    try:
        f = hl.Func("l28_f")
        f[x] = hl.print_expr(x * x, "squares")
        out = f.realize([4], device=device).to_numpy()
    finally:
        hl.set_custom_print(prev)
    np.testing.assert_array_equal(out, [0, 1, 4, 9])
    assert "squares" in msgs[0]

    # 2. require() checks its predicate at runtime; violations route to
    # the error handler instead of crashing the process
    errs = []
    prev = hl.set_error_handler(errs.append)
    try:
        p = hl.Param(hl.Int(32), "l28_p")
        p.set(3)
        g = hl.Func("l28_g")
        g[x] = hl.require(p > 0, x + p)
        np.testing.assert_array_equal(
            g.realize([3], device=device).to_numpy(), [3, 4, 5])
        assert not errs            # satisfied: no error
        p.set(-1)
        g2 = hl.Func("l28_g2")
        g2[x] = hl.require(p > 0, x + p)
        g2.realize([3], device=device)
        assert errs and "Requirement Failed" in errs[0]
    finally:
        hl.set_error_handler(prev)

    # 3. debug_to_file dumps every production of a Func
    with tempfile.TemporaryDirectory() as d:
        npy = os.path.join(d, "stage.npy")
        h1, h2 = hl.Func("l28_h1"), hl.Func("l28_h2")
        h1[x] = x * 10
        h2[x] = h1[x] + 1
        h1.compute_root()
        h1.debug_to_file(npy)
        h2.realize([5], device=device)
        dumped = np.load(npy)
        np.testing.assert_array_equal(dumped, np.arange(5) * 10)
    print("lesson 28: handlers + require + debug_to_file ok",
          len(msgs), "prints,", len(errs), "errors")


if __name__ == "__main__":
    main()
