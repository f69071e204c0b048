"""Lesson 29: sharded reductions -- distribute(rvar) slices the reduction
domain across the shards of a mesh; their partials are combined in shard
order (the SURVEY §2.6 plan; the reference is single-node)."""
import numpy as np
import torch

import halide_tpu_torch as hl


def main(device=None):
    from halide_tpu_torch.parallel import Mesh
    from halide_tpu_torch.pipeline import resolve_device

    dev = resolve_device(device)
    n = 4
    W, H, B = 32, 8 * n, 16
    rng = np.random.default_rng(0)
    img = rng.integers(0, B, (H, W)).astype(np.int32)

    b = hl.Var("b")
    inp = hl.ImageParam(hl.Int(32), 2, "l29_in")
    inp.set(torch.from_numpy(img).to(dev))
    r = hl.RDom(0, W, 0, H, "l29_r")
    hist = hl.Func("l29_hist")
    hist[b] = 0
    hist[hl.clamp(inp[r.x, r.y], 0, B - 1)] += 1
    # slice the ROW axis of the reduction across the mesh: each shard
    # histograms its slab of the input, then the partials are added in
    # shard order
    hist.distribute(r.y, "shards")
    mesh = Mesh([dev] * n, ("shards",))
    out = hl.Pipeline(hist).realize([B], mesh=mesh).to_numpy()
    np.testing.assert_array_equal(
        np.asarray(out), np.bincount(img.ravel(), minlength=B))
    print(f"lesson 29: distributed histogram over {n} shards on {dev} "
          "matches")


if __name__ == "__main__":
    main()
