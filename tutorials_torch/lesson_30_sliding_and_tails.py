"""Lesson 30: sliding-window storage and tail strategies
(reference: tutorial/lesson_08_scheduling_2.cpp store_at/compute_at,
src/SlidingWindow.cpp, src/Schedule.h:35-139 TailStrategy).

Two classic Halide scheduling ideas and what K1 does with them:

1. SLIDING WINDOW -- `store_at(consumer, outer)` + `compute_at(consumer,
   inner)`: the producer's storage outlives the inner loop, so the
   reference computes only the NEW slice each step. K1 computes the
   producer whole in every sub-tile instead, halo included, as it does
   for any compute_at producer: each block runs on its own, and carrying
   the overlap from one sub-tile to the next measured slower on the H100.
   The store level is recorded and changes no plan.

2. TAIL STRATEGIES -- what happens when an extent is not a tile
   multiple. RoundUp pads the grid and crops the output (over-compute).
   Auto/ShiftInwards instead shift the last sub-tile of each row and
   column inward so that it ends at the extent, recomputing only the
   overlap (the reference's ShiftInwards): no output is written twice
   from different values, and no read leaves the footprint.
"""
import numpy as np
import halide_tpu_torch as hl


def main(device=None):
    x, y = hl.Var("x"), hl.Var("y")
    xo, yo, xi, yi = (hl.Var(n) for n in "xo yo xi yi".split())
    rng = np.random.default_rng(30)
    img = rng.integers(0, 1 << 14, (256, 512), np.uint16)
    inp = hl.Buffer(img, name="l30_in")

    # vertical blur producer, horizontal blur consumer: the consumer's
    # x stencil gives the producer a 2-column overlap between adjacent
    # x sub-tiles -- what a sliding window would reuse
    bv, bh = hl.Func("l30_bv"), hl.Func("l30_bh")
    bv[x, y] = (inp[x, y] + inp[x, y + 1] + inp[x, y + 2]) / 3
    bh[x, y] = (bv[x, y] + bv[x + 1, y] + bv[x + 2, y]) / 3

    bh.tile(x, y, xo, yo, xi, yi, 128, 64).vectorize(xi).parallel(yo)
    bv.compute_at(bh, xo).store_at(bh, yo)   # storage encloses the x loop

    W, H = 510, 254       # NOT tile multiples: the tail path engages too
    out = bh.realize([W, H], device=device).to_numpy()

    ref = (img[:-2].astype(np.uint16) + img[1:-1] + img[2:]) // 3
    ref = (ref[:, :-2] + ref[:, 1:-1] + ref[:, 2:]) // 3
    assert np.array_equal(out, ref[:H, :W])

    # the plan: l30_bv a member, nothing carried, one sub-tile a block
    from halide_tpu_torch.ops import group_kernel as gk
    plan = gk.last_plan
    assert plan is not None and plan["members"] == ["l30_bv"], plan
    assert "sliding" not in plan and plan["grid"] == plan["sub_tiles"], plan
    sx, sy = plan["sub_tile"]
    ncx, ncy = plan["sub_tiles"]
    # the sub-tiles cover the extent once; the last of each row and column
    # is shifted inward where the extent is not a multiple
    assert ncx == -(-W // sx) and ncy == -(-H // sy), plan
    print("lesson_30: l30_bv computed whole in each of",
          f"{ncx}x{ncy} sub-tiles of {sx}x{sy},",
          "the last shifted inward" if W % sx or H % sy else "")
    print("Success!")


if __name__ == "__main__":
    main()
