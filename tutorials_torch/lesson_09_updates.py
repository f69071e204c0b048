"""Lesson 9: update definitions, RDoms, histograms, scans
(reference: lesson_09)."""
import numpy as np
import halide_tpu_torch as hl


def main(device=None):
    x = hl.Var("x")
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (64, 64), np.uint8)
    inp = hl.Buffer(data)

    hist = hl.Func("hist")
    r = hl.RDom(0, 64, 0, 64, "r")
    hist[x] = 0
    hist[hl.i32(inp[r.x, r.y])] += 1       # scatter -> one pass of counts
    np.testing.assert_array_equal(
        hist.realize([256], device=device).to_numpy(),
        np.bincount(data.ravel(), minlength=256))

    cdf = hl.Func("cdf")
    b = hl.RDom(1, 255, "b")
    cdf[x] = hist[0]
    cdf[b.x] = cdf[b.x - 1] + hist[b.x]    # scan -> a cumulative sum
    np.testing.assert_array_equal(
        cdf.realize([256], device=device).to_numpy(),
        np.cumsum(np.bincount(data.ravel(), minlength=256)))
    print("lesson 09: histogram + cdf match")


if __name__ == "__main__":
    main()
