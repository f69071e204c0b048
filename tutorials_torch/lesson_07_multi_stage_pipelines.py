"""Lesson 7: multi-stage pipelines and boundary conditions
(reference: tutorial/lesson_07_multi_stage_pipelines.cpp).

Stages are Funcs calling Funcs. By default a producer is INLINED into its
consumer (zero storage, recompute per use); `compute_root()` materializes
it once. Stencils need out-of-range reads defined -- either clamp the
coordinates yourself or use the boundary-condition combinators
(hl.repeat_edge & friends, reference src/BoundaryConditions.h).
"""
import numpy as np
import halide_tpu_torch as hl


def main(device=None):
    x, y, c = hl.Var("x"), hl.Var("y"), hl.Var("c")
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (3, 64, 96), np.uint8)   # [c, y, x] planar
    inp = hl.Buffer(img, name="l07_in")

    # widen before summing: u8 + u8 overflows at 255, so lift to u16
    # (the reference lesson makes exactly this point)
    input_16 = hl.Func("l07_in16")
    input_16[x, y, c] = hl.u16(inp[x, y, c])

    # horizontal then vertical 1-2-1 blur over the interior
    blur_x = hl.Func("l07_bx")
    blur_y = hl.Func("l07_by")
    blur_x[x, y, c] = (input_16[x - 1, y, c] + 2 * input_16[x, y, c]
                       + input_16[x + 1, y, c]) / 4
    blur_y[x, y, c] = (blur_x[x, y - 1, c] + 2 * blur_x[x, y, c]
                       + blur_x[x, y + 1, c]) / 4
    output = hl.Func("l07_out")
    output[x, y, c] = hl.u8(blur_y[x, y, c])

    # the interior box [1, w-2] x [1, h-2] never reads out of range
    out = hl.Buffer(type=hl.UInt(8), sizes=[94, 62, 3], mins=[1, 1, 0])
    output.realize(dst=out, device=device)

    a = img.astype(np.uint16)
    bx = (a[:, :, :-2] + 2 * a[:, :, 1:-1] + a[:, :, 2:]) // 4
    by = (bx[:, :-2, :] + 2 * bx[:, 1:-1, :] + bx[:, 2:, :]) // 4
    np.testing.assert_array_equal(out.to_numpy(), by.astype(np.uint8))

    # boundary condition: clamp reads so the FULL box is realizable
    clamped = hl.repeat_edge(inp)
    in16b = hl.Func("l07_in16b")
    in16b[x, y, c] = hl.u16(clamped[x, y, c])
    bx2, by2 = hl.Func("l07_bx2"), hl.Func("l07_by2")
    bx2[x, y, c] = (in16b[x - 1, y, c] + 2 * in16b[x, y, c]
                    + in16b[x + 1, y, c]) / 4
    by2[x, y, c] = (bx2[x, y - 1, c] + 2 * bx2[x, y, c]
                    + bx2[x, y + 1, c]) / 4
    full = hl.Func("l07_full")
    full[x, y, c] = hl.u8(by2[x, y, c])
    out2 = full.realize([96, 64, 3], device=device).to_numpy()
    assert out2.shape == (3, 64, 96)
    # interior matches the unclamped pipeline
    np.testing.assert_array_equal(out2[:, 1:-1, 1:-1],
                                  by.astype(np.uint8))
    print("lesson 07: multi-stage + boundary conditions OK")


if __name__ == "__main__":
    main()
