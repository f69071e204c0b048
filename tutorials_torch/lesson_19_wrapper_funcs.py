"""Lesson 19: wrapper funcs -- scheduling a call site, not a callee
(reference: tutorial/lesson_19_wrapper_funcs.cpp).

f.in_(g) interposes a new Func between f and the consumer g:
g then reads f_in, and f_in (an identity over f) can be scheduled
independently -- per-consumer staging granularity without touching f or
duplicating its definition.
"""
import numpy as np
import halide_tpu_torch as hl


def main(device=None):
    x, y = hl.Var("x"), hl.Var("y")
    f = hl.Func("l19_f")
    f[x, y] = x + y
    f.compute_root()

    g = hl.Func("l19_g")
    h = hl.Func("l19_h")
    g[x, y] = f[x, y] * 2
    h[x, y] = f[x, y] + 7

    # stage f's values differently for g only; h still reads f directly
    f_in_g = f.in_(g)
    f_in_g.compute_root()

    pipe = hl.Pipeline([g, h])
    outs = pipe.realize([32, 16], device=device)
    want = np.add.outer(np.arange(16), np.arange(32))
    np.testing.assert_array_equal(outs[0].to_numpy(), want * 2)
    np.testing.assert_array_equal(outs[1].to_numpy(), want + 7)

    # the wrapper is a real stage in the graph
    from halide_tpu_torch.pipeline import gather_graph
    names = [fn.name for fn in gather_graph(pipe.outputs).funcs]
    assert any("l19_f_in" in n for n in names), names
    print("lesson 19: wrapper funcs OK;", names)


if __name__ == "__main__":
    main()
