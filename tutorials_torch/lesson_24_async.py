"""Lesson 24: asynchronous producers
(reference: tutorial/lesson_24_async.cpp, src/AsyncProducers.cpp).

The reference overlaps a producer's work with its consumer via async() +
ring buffers and semaphores. The port records the request
(`async_requested` in the group kernel's plan) and answers it with the
plan it gives every group: a block of K1 stages its sub-tile's input
windows into one shared-memory buffer (by cp.async, global to shared
memory, where the strides allow), then computes the producer and the
consumer there. Other resident blocks of the SM compute while one waits
on its copies: the latency hiding comes from the blocks an SM keeps, not
from a second buffer (a double-buffered walk measured slower on the
H100).
"""
import numpy as np
import halide_tpu_torch as hl


def main(device=None):
    x, y = hl.Var("x"), hl.Var("y")
    xo, yo, xi, yi = (hl.Var(n) for n in "xo yo xi yi".split())
    rng = np.random.default_rng(24)
    img = rng.integers(0, 1 << 14, (512, 1024), np.uint16)
    inp = hl.Buffer(img, name="l24_in")

    bx, by = hl.Func("l24_bx"), hl.Func("l24_by")
    bx[x, y] = (inp[x, y] + inp[x + 1, y] + inp[x + 2, y]) / 3
    by[x, y] = (bx[x, y] + bx[x, y + 1] + bx[x, y + 2]) / 3
    # full-width row bands, parallel(yo); bx computed at the tiles and
    # asked to run asynchronously
    by.tile(x, y, xo, yo, xi, yi, 1022, 128).vectorize(xi).parallel(yo)
    bx.compute_at(by, xo).async_()

    from halide_tpu_torch.ops import group_kernel as gk
    gk.last_plan = None
    out = by.realize([1022, 510], jit=False, device=device).to_numpy()

    a = img.astype(np.uint16)
    r1 = (a[:, :-2] + a[:, 1:-1] + a[:, 2:]) // 3
    ref = (r1[:-2] + r1[1:-1] + r1[2:]) // 3
    np.testing.assert_array_equal(out, ref)

    plan = gk.last_plan
    # the request is recorded, and the plan is one sub-tile a block
    assert plan is not None and plan["async_requested"], plan
    assert plan["grid"] == plan["sub_tiles"], plan
    print("lesson 24: async() recorded; one sub-tile a block:",
          {k: plan[k] for k in ("sub_tile", "grid", "threads",
                                "smem_bytes")})


if __name__ == "__main__":
    main()
