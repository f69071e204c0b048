"""Lesson 21: the autoscheduler (reference: lesson_21)."""
import numpy as np
import halide_tpu_torch as hl


def main(device=None):
    x, y = hl.Var("x"), hl.Var("y")
    inp = hl.ImageParam(hl.Float(32), 2, "in21")
    bx, by = hl.Func("t21_bx"), hl.Func("t21_by")
    bx[x, y] = (inp[x, y] + inp[x + 1, y] + inp[x + 2, y]) / 3
    by[x, y] = (bx[x, y] + bx[x, y + 1] + bx[x, y + 2]) / 3
    by.set_estimates([(0, 1000), (0, 1000)])
    result = hl.Pipeline(by).apply_autoscheduler(
        params={"name": "Mullapudi2016"})
    print("lesson 21 schedule:\n" + result["schedule_source"])
    inp.set(np.random.default_rng(0).random((66, 130), np.float32))
    by.realize([128, 64], device=device)
    print("lesson 21: autoscheduled pipeline runs")


if __name__ == "__main__":
    main()
