"""Lesson 25: scaling out -- row sharding with halo exchange over a mesh
(this replaces the reference's single-node async lesson with the
distribution story).

A `parallel.Mesh` is an array of shard slots, each on a torch.device. Here
four slots share the given device: the port's single-card mesh, where each
shard's slab and its halo rows are slices of the input and the shards run
one after another. With slots on several cards the same code copies the
halo rows between them.
"""
import numpy as np
import torch


def main(device=None):
    import halide_tpu_torch as hl
    from halide_tpu_torch.parallel import Mesh, sharded_realize_rows
    from halide_tpu_torch.pipeline import resolve_device

    dev = resolve_device(device)
    n = 4
    W, H = 64, 8 * n
    mesh = Mesh([dev] * n, ("y",))

    def build(inp):
        x, y = hl.Var("x"), hl.Var("y")
        f = hl.Func("l25")
        f[x, y] = (inp[hl.clamp(x - 1, 0, W - 1), y]
                   + inp[hl.clamp(x + 1, 0, W - 1), y]
                   + inp[x, y - 1] + inp[x, y + 1]) / 4
        return hl.Pipeline(f)

    fn = sharded_realize_rows(build, W, H, mesh, "y", halo=1)
    img = np.random.default_rng(0).random((H, W)).astype(np.float32)
    out = fn(torch.from_numpy(img).to(dev))
    # the unsharded stencil, y edges repeated as at the mesh's ends
    p = np.pad(img, ((1, 1), (0, 0)), mode="edge")
    pad_x = np.pad(img, ((0, 0), (1, 1)), mode="edge")
    want = (pad_x[:, :-2] + pad_x[:, 2:] + p[:-2] + p[2:]) / 4
    np.testing.assert_allclose(out.cpu().numpy(), want, rtol=1e-6)
    print("lesson 25: sharded realize over", n, "shards on", dev, "->",
          tuple(out.shape))


if __name__ == "__main__":
    main()
