"""Lesson 1: Funcs, Vars, Exprs, realize (reference: tutorial/lesson_01).

Every lesson's main(device) realizes on `device`: None means the card,
and raises where there is none; "cpu" runs the same program with torch on
the CPU."""
import halide_tpu_torch as hl


def main(device=None):
    x, y = hl.Var("x"), hl.Var("y")
    gradient = hl.Func("gradient")
    gradient[x, y] = x + y                      # the algorithm
    out = gradient.realize([800, 600], device=device)   # plan + run
    assert out.at(10, 20) == 30
    print("lesson 01: gradient(10,20) =", out.at(10, 20))


if __name__ == "__main__":
    main()
