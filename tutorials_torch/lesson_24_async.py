"""Lesson 24: asynchronous producers -- double-buffered window copies
(reference: tutorial/lesson_24_async.cpp, src/AsyncProducers.cpp).

The reference overlaps a producer's work with its consumer via async() +
ring buffers and semaphores. The GPU analog lives inside the group
kernel K1: where a block walks several sub-tiles in a row, it issues the
NEXT sub-tile's input window copies (cp.async, global to shared memory)
before it computes the current one, alternating between two window
buffers -- the copies run ahead of the arithmetic, hiding load latency
like the reference's producer thread. No directive is needed; the plan
takes it whenever a block walks and both buffers fit in shared memory,
and records the decision for inspection. Here the walk comes from a
sliding window (store_root, lesson 30): a block walks the sub-tiles of
a band, carrying the producer's overlap from one step to the next.
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
    # full-width row bands, parallel(yo): a block walks the sub-tiles of
    # its band down y, carrying bx's two-row overlap (stored at root)
    by.tile(x, y, xo, yo, xi, yi, 1022, 128).vectorize(xi).parallel(yo)
    bx.compute_at(by, xo).store_root()

    from halide_tpu_torch.ops import group_kernel as gk
    gk.last_plan = None
    out = by.realize([1022, 510], jit=False, device=device).to_numpy()

    a = img.astype(np.uint16)
    r1 = (a[:, :-2] + a[:, 1:-1] + a[:, 2:]) // 3
    ref = (r1[:-2] + r1[1:-1] + r1[2:]) // 3
    np.testing.assert_array_equal(out, ref)

    plan = gk.last_plan
    assert plan is not None and plan["walk"] > 1, plan
    assert plan["n_buf"] == 2 and plan["prefetch"] == "cp.async", plan
    print("lesson 24: double-buffered window copies:",
          {k: plan[k] for k in ("sub_tile", "walk", "n_buf", "prefetch",
                                "sliding", "smem_bytes")})


if __name__ == "__main__":
    main()
