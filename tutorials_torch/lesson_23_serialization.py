"""Lesson 23: pipeline serialization (reference: lesson_23)."""
import numpy as np
import halide_tpu_torch as hl


def main(device=None):
    x = hl.Var("x")
    inp = hl.ImageParam(hl.Float(32), 1, "in23")
    f = hl.Func("t23")
    f[x] = inp[x] * 2.0 + 1.0
    text = hl.serialize_pipeline(hl.Pipeline(f))
    pipe, images, _params = hl.deserialize_pipeline(text)
    images["in23"].set(np.arange(5, dtype=np.float32))
    out = pipe.realize([5], device=device).to_numpy()
    np.testing.assert_allclose(out, np.arange(5) * 2 + 1)
    print("lesson 23: round-tripped pipeline runs")


if __name__ == "__main__":
    main()
