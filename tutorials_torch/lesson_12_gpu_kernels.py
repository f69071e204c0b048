"""Lesson 12: offloading a scheduled group to a GPU kernel
(reference: tutorial/lesson_12_using_the_gpu.cpp).

The reference's gpu_tile() maps a tile onto CUDA blocks/threads. Here the
same schedule shape -- tile the consumer, compute producers at the tile --
lowers the whole group into ONE GPU kernel, K1 (CUDA C++ emitted for the
group and built with nvcc for sm_90a):

    tile          -> the output's tiles; K1 plans sub-tiles within them,
                     one block each (the grid)
    compute_at    -> producer evaluated inside the kernel, its window held
                     in shared memory
    parallel(yo)  -> blocks run at once (with full-width tiles the plan
                     records a band walk, the JAX planner's band split;
                     a block still computes one sub-tile)
    vectorize(xi) -> advisory; a block's threads already cover the tile

On the CPU the same plan runs as its plain PyTorch version; the schedule
is semantics-preserving either way. A schedule the plan cannot take is
evaluated whole-array, and the reason is counted
(group_kernel.rejects); a build or launch failure raises.
"""
import numpy as np
import torch

import halide_tpu_torch as hl


def main(device=None):
    x, y = hl.Var("x"), hl.Var("y")
    xo, yo, xi, yi = (hl.Var(n) for n in "xo yo xi yi".split())

    rng = np.random.default_rng(12)
    img = rng.integers(0, 1 << 14, (128, 256), np.uint16)
    inp = hl.Buffer(img, name="l12_in")

    blur_x = hl.Func("l12_bx")
    blur_y = hl.Func("l12_by")
    blur_x[x, y] = (inp[x, y] + inp[x + 1, y] + inp[x + 2, y]) / 3
    blur_y[x, y] = (blur_x[x, y] + blur_x[x, y + 1] + blur_x[x, y + 2]) / 3

    # the "gpu_tile" of this world:
    blur_y.tile(x, y, xo, yo, xi, yi, 128, 32).vectorize(xi).parallel(yo)
    blur_x.compute_at(blur_y, xo)

    # confirm the kernel path actually engages (not a whole-array
    # evaluation of the group)
    from halide_tpu_torch.ops import group_kernel as gk
    engaged = []
    orig = gk.try_group

    def spy(*a, **kw):
        r = orig(*a, **kw)
        engaged.append(r is not None)
        return r

    gk.try_group = spy
    n0 = gk.launches
    try:
        out = blur_y.realize([254, 126], jit=False,
                             device=device).to_numpy()
    finally:
        gk.try_group = orig
    launched = gk.launches - n0
    a = img.astype(np.uint16)
    bx = (a[:, :-2] + a[:, 1:-1] + a[:, 2:]) // 3
    ref = (bx[:-2] + bx[1:-1] + bx[2:]) // 3
    np.testing.assert_array_equal(out, ref)
    assert engaged and engaged[-1], "the group kernel's plan was refused"
    # on the card the plan is launched as K1 (a launch is counted); on the
    # CPU its plain version computes it
    on_card = torch.device("cuda" if device is None else device).type \
        == "cuda"
    assert launched == (1 if on_card else 0), launched
    # the plan records the sub-tile, threads, shared memory and grid
    print("lesson 12: GPU group kernel engaged,", launched,
          "K1 launch(es); plan:", gk.last_plan)


if __name__ == "__main__":
    main()
