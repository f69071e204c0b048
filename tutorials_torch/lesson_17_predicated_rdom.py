"""Lesson 17: predicated reduction domains
(reference: tutorial/lesson_17_predicated_rdom.cpp).

r.where(pred) restricts a reduction to the sub-domain where pred holds --
a circle, a triangle, a data-dependent region. The torch lowering folds
each predicate into a mask inside the (associative) combine, so
predication costs a compare-select, not control flow.
"""
import numpy as np
import halide_tpu_torch as hl


def main(device=None):
    x, y = hl.Var("x"), hl.Var("y")
    rng = np.random.default_rng(17)
    img = rng.integers(0, 100, (8, 10), np.int32)
    inp = hl.Buffer(img, name="l17_in")

    # sum over the circle of radius 3 centered at (4, 3)
    circle = hl.Func("l17_circle")
    circle[x, y] = 0
    r = hl.RDom(0, 10, 0, 8, "r")
    r.where((r.x - 4) * (r.x - 4) + (r.y - 3) * (r.y - 3) <= 9)
    circle[x, y] += inp[r.x, r.y]
    got = int(circle.realize([1, 1], device=device).to_numpy()[0, 0])

    xs, ys = np.meshgrid(np.arange(10), np.arange(8))
    mask = (xs - 4) ** 2 + (ys - 3) ** 2 <= 9
    assert got == int(img[mask].sum())

    # two predicates AND together; they may read the input itself.
    # (An RDom participates in an update only when referenced by it --
    # `f[x] += 1` alone would NOT loop over r2, same as the reference.)
    odd_big = hl.Func("l17_oddbig")
    odd_big[x] = 0
    r2 = hl.RDom(0, 10, 0, 8, "r2")
    r2.where(inp[r2.x, r2.y] % 2 == 1)
    r2.where(inp[r2.x, r2.y] > 50)
    odd_big[x] += inp[r2.x, r2.y]
    n = int(odd_big.realize([1], device=device).to_numpy()[0])
    mask2 = (img % 2 == 1) & (img > 50)
    assert n == int(img[mask2].sum())
    print(f"lesson 17: circle sum {got}, odd>50 sum {n}")


if __name__ == "__main__":
    main()
