"""Lesson 5: scheduling -- reorder/split/tile/vectorize/parallel and what
they mean on a GPU (reference: lesson_05)."""
import numpy as np
import halide_tpu_torch as hl


def main(device=None):
    x, y = hl.Var("x"), hl.Var("y")
    xo, yo, xi, yi = (hl.Var(n) for n in "xo yo xi yi".split())
    gradient = hl.Func("gradient_tiled")
    gradient[x, y] = x + y
    # tile -> the GPU kernel's grid of blocks; vectorize -> advisory (a
    # block's threads already cover the tile); parallel -> blocks run at
    # once (all semantics-preserving)
    gradient.tile(x, y, xo, yo, xi, yi, 64, 16).vectorize(xi).parallel(yo)
    out = gradient.realize([256, 128], device=device).to_numpy()
    np.testing.assert_array_equal(
        out, np.add.outer(np.arange(128), np.arange(256)))
    print("lesson 05: tiled schedule matches")


if __name__ == "__main__":
    main()
