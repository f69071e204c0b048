"""Lesson 26: gradients through pipelines (reference: python autodiff
tutorial / Derivative.h)."""
import numpy as np
import halide_tpu_torch as hl


def main(device=None):
    x = hl.Var("x")
    img = hl.ImageParam(hl.Float(32), 1, "in19")
    loss_f = hl.Func("t19")
    loss_f[x] = img[x] * img[x]
    data = np.arange(4, dtype=np.float32)
    img.set(data)
    grads = hl.propagate_adjoints(loss_f, sizes=[4], device=device)
    np.testing.assert_allclose(grads["in19"], 2 * data)
    print("lesson 26: d(sum x^2)/dx =", grads["in19"])


if __name__ == "__main__":
    main()
