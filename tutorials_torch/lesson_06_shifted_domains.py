"""Lesson 6: realizing over shifted domains
(reference: tutorial/lesson_06_realizing_over_shifted_domains.cpp).

A Func has no intrinsic origin: you can realize any axis-aligned box,
including one that does not start at (0, 0). The runtime Buffer carries
per-dimension `min`s (the reference's halide_buffer_t dim.min), and
reads/writes are offset accordingly -- useful for tiling a huge image in
pieces without re-indexing the algorithm.
"""
import halide_tpu_torch as hl


def main(device=None):
    x, y = hl.Var("x"), hl.Var("y")
    gradient = hl.Func("l06_gradient")
    gradient[x, y] = x + y

    # realize the 4x4 box whose top-left corner is (100, 50)
    dst = hl.Buffer(type=hl.Int(32), sizes=[4, 4], mins=[100, 50])
    gradient.realize(dst=dst, device=device)
    arr = dst.to_numpy()            # numpy array indexed [y - 50, x - 100]
    assert arr[0, 0] == 150         # gradient(100, 50)
    assert arr[3, 3] == 156         # gradient(103, 53)
    assert dst.at(102, 51) == 153   # .at() uses Func coordinates

    # the same algorithm, a different window: the origin is part of the
    # plan cache's key, so a second window plans once more
    dst2 = hl.Buffer(type=hl.Int(32), sizes=[4, 4], mins=[-8, -8])
    gradient.realize(dst=dst2, device=device)
    assert dst2.at(-8, -8) == -16
    print("lesson 06: shifted realizations OK")


if __name__ == "__main__":
    main()
