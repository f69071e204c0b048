"""Lesson 16: RGB images and memory layouts
(reference: tutorial/lesson_16_rgb_generate.cpp).

The reference contrasts planar vs interleaved channel layouts and
specializes loops for each. On a GPU the contiguous axis should be the
one that a warp's 32 threads read side by side (coalesced loads), so
PLANAR (x minor, c outermost) is the right layout and `reorder`
expresses the choice at the schedule level; interleaved layouts come
in/out via the host numpy arrays without entering the hot loop.
"""
import numpy as np
import halide_tpu_torch as hl


def main(device=None):
    x, y, c = hl.Var("x"), hl.Var("y"), hl.Var("c")
    rng = np.random.default_rng(16)
    img = rng.integers(0, 255, (3, 32, 48), np.uint8)     # planar [c,y,x]
    inp = hl.Buffer(img, name="l16_in")

    brighter = hl.Func("l16_brighter")
    brighter[x, y, c] = inp[x, y, c] + hl.u8(1)

    # planar realize: dims (x, y, c) -> numpy [c, y, x]; x is the minor
    # (contiguous) axis, c the outermost -- each channel plane is a 2-D
    # array whose rows a warp reads coalesced
    out = brighter.realize([48, 32, 3], device=device).to_numpy()
    np.testing.assert_array_equal(out, img + 1)

    # reorder(c, x, y) asks for c innermost (the interleaved traversal);
    # here it is accepted-but-advisory: torch owns the tensor layout, and
    # a 3-extent minor axis would make a warp's loads strided.
    inter = hl.Func("l16_inter")
    inter[x, y, c] = inp[x, y, c] + hl.u8(1)
    inter.reorder(c, x, y)
    out2 = inter.realize([48, 32, 3], device=device).to_numpy()
    np.testing.assert_array_equal(out2, img + 1)

    # interleaved host data: convert at the boundary, not in the loop
    interleaved = np.moveaxis(img, 0, -1)                 # [y, x, c]
    planar_again = np.moveaxis(interleaved, -1, 0)
    np.testing.assert_array_equal(planar_again, img)
    print("lesson 16: RGB layouts OK")


if __name__ == "__main__":
    main()
