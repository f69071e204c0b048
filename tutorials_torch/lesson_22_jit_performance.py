"""Lesson 22: plan caches and how to benchmark
(reference: tutorial/lesson_22_jit_performance.cpp).

The first realize gathers the graph, infers bounds and plans every group
(on the card also building each group kernel's source with nvcc, seconds
the first time, a file on disk after). Re-realizing with the same graph
SIGNATURE -- same structure, shapes, dtypes, schedules, parameter values
-- reuses the planned `run` from the plan cache; only the inputs' VALUES
change. Benchmark steady state, never the first call; on the card time
with CUDA events after a synchronize, as tools/timer.py does.
"""
import time

import numpy as np
import halide_tpu_torch as hl


def main(device=None):
    x, y = hl.Var("x"), hl.Var("y")
    img = hl.ImageParam(hl.Float(32), 2, "l22_in")
    f = hl.Func("l22_f")
    f[x, y] = hl.sqrt(img[x, y] * 2.0 + 1.0) + hl.sin(img[x, y])
    pipe = hl.Pipeline(f)

    rng = np.random.default_rng(22)
    img.set(rng.random((256, 256), np.float32))

    t0 = time.perf_counter()
    pipe.realize([256, 256], device=device)
    cold = time.perf_counter() - t0

    # warm calls hit the plan cache; the steady state is the fastest of
    # them (a busy host only ever adds time to a call)
    warm = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        out = pipe.realize([256, 256], device=device)
        warm = min(warm, time.perf_counter() - t0)
    assert warm < cold, (warm, cold)
    assert len(pipe._plan_cache) == 1

    # new VALUES don't plan again...
    img.set(rng.random((256, 256), np.float32))
    t0 = time.perf_counter()
    pipe.realize([256, 256], device=device)
    revalue = time.perf_counter() - t0
    assert len(pipe._plan_cache) == 1
    # ...but a new SHAPE is a new signature (planned again)
    img.set(rng.random((128, 128), np.float32))
    t0 = time.perf_counter()
    pipe.realize([128, 128], device=device)
    reshape = time.perf_counter() - t0
    assert len(pipe._plan_cache) == 2
    print(f"lesson 22: cold {cold*1e3:.1f}ms warm {warm*1e3:.2f}ms "
          f"new-values {revalue*1e3:.2f}ms new-shape {reshape*1e3:.1f}ms")
    out.to_numpy()


if __name__ == "__main__":
    main()
