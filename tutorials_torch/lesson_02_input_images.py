"""Lesson 2: input images + boundary conditions (reference: lesson_02)."""
import numpy as np
import halide_tpu_torch as hl


def main(device=None):
    x, y, c = hl.Var("x"), hl.Var("y"), hl.Var("c")
    rng = np.random.default_rng(0)
    img = rng.random((3, 120, 160), np.float32)   # np[c, y, x]
    input_buf = hl.Buffer(img, name="input")
    clamped = hl.repeat_edge(input_buf)
    brighter = hl.Func("brighter")
    brighter[x, y, c] = hl.min(clamped[x, y, c] * 1.5, 1.0)
    out = brighter.realize([160, 120, 3], device=device).to_numpy()
    np.testing.assert_allclose(out, np.minimum(img * 1.5, 1.0), rtol=1e-6)
    print("lesson 02: ok")


if __name__ == "__main__":
    main()
