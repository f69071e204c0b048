"""Lesson 13: tuples -- multi-valued Funcs, argmax (reference: lesson_13)."""
import numpy as np
import halide_tpu_torch as hl


def main(device=None):
    x = hl.Var("x")
    data = np.array([3, 1, 4, 1, 5, 9, 2, 6], np.int32)
    inp = hl.Buffer(data)
    r = hl.RDom(0, 8, "r13")
    best = hl.Func("best")
    am = hl.argmax(inp[r.x + 0 * x])
    best[x] = (am[0], am[1])        # (index, value)
    out = best.realize([1], device=device)
    assert out[0].at(0) == 5 and out[1].at(0) == 9
    print("lesson 13: argmax =", out[0].at(0), out[1].at(0))


if __name__ == "__main__":
    main()
