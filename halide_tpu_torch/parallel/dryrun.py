"""A dry run of the sharded paths over an n-slot mesh at tiny shapes: the
port's counterpart of `__graft_entry__.dryrun_multichip`.

    python -c "from halide_tpu_torch.parallel.dryrun import \
        dryrun_multichip; print(dryrun_multichip(4, 'cpu'))"

1. spatial sharding: a row-sharded stencil through `sharded_realize_rows`,
   bit for bit against the unsharded realize;
2. a data x tensor-parallel training step of relu(conv) built on the DSL:
   the batch split over "data", the output channels over "model"; each
   shard runs forward and backward through torch.autograd, the weight
   gradients are combined over "data" in shard order, then one SGD step,
   held against the unsharded step within rtol 1e-5;
3. a sharded reduction: a histogram whose RDom row axis is sharded by
   `f.distribute(r.y)`, bit for bit against np.bincount.
"""
from __future__ import annotations

import numpy as np
import torch

from .distribute import combine, sharded_realize_rows
from .mesh import Mesh


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the three parts on a mesh of `n_devices` slots of `device`
    (None: the card) -> {part: what it checked}; raises on a mismatch."""
    import halide_tpu_torch as hl
    from ..pipeline import resolve_device

    dev = resolve_device(device)
    devs = [dev] * n_devices
    rng = np.random.default_rng(0)
    report = {}

    # ---- 1. spatial sharding with halo exchange -------------------------
    mesh1 = Mesh(devs, ("y",))
    W, Hs = 64, 8
    H = Hs * n_devices

    def build(inp):
        x, y = hl.Var("x"), hl.Var("y")
        cl = hl.Func("cl")
        cl[x, y] = inp[hl.clamp(x, 0, W - 1), y]
        bx = hl.Func("bx")
        by = hl.Func("by")
        bx[x, y] = (cl[x - 1, y] + cl[x, y] + cl[x + 1, y]) / 3
        by[x, y] = (bx[x, y - 1] + bx[x, y] + bx[x, y + 1]) / 3
        return hl.Pipeline(by)

    fn = sharded_realize_rows(build, W, H, mesh1, "y", halo=1)
    img = rng.integers(0, 1 << 12, size=(H, W), dtype=np.uint16)
    out = fn(torch.from_numpy(img).to(dev))
    assert tuple(out.shape) == (H, W), out.shape
    # the same stencil unsharded, its y edges repeated as at the mesh's ends
    ref = build(hl.repeat_edge(hl.Buffer(torch.from_numpy(img).to(
        dev)))).realize([W, H], device=dev).data
    if not torch.equal(out, ref):
        raise AssertionError("sharded stencil differs from the unsharded")
    report["rows"] = {"shape": [H, W], "shards": n_devices}

    # ---- 2. dp x tp training step over the Func-DSL conv ----------------
    if n_devices % 2 == 0:
        mesh2 = Mesh(np.array(devs, dtype=object).reshape(
            n_devices // 2, 2), ("data", "model"))
    else:
        mesh2 = Mesh(np.array(devs, dtype=object).reshape(n_devices, 1),
                     ("data", "model"))
    report["train"] = _train_step(hl, mesh2, rng, dev)

    # ---- 3. sharded reduction: distributed histogram --------------------
    Wh, Hh, B = 32, 8 * n_devices, 16
    himg = rng.integers(0, B, (Hh, Wh)).astype(np.int32)
    mesh3 = Mesh(devs, ("shards",))
    hout = sharded_histogram(torch.from_numpy(himg).to(dev), B).realize(
        [B], mesh=mesh3).to_numpy()
    expect = np.bincount(himg.ravel(), minlength=B)
    if not (np.asarray(hout) == expect).all():
        raise AssertionError("sharded histogram mismatch")
    report["hist"] = {"bins": B, "shards": n_devices}
    return report


def sharded_histogram(img, bins: int):
    """A histogram of the int32 image `img` into `bins` bins (values
    clamped) whose RDom row axis is sharded: `distribute(r.y, "shards")`.
    -> the pipeline."""
    import halide_tpu_torch as hl
    b = hl.Var("b")
    inp = hl.ImageParam(hl.Int(32), 2, "dh_in")
    inp.set(img)
    r = hl.RDom(0, img.shape[1], 0, img.shape[0], "dh_r")
    h = hl.Func("dh_out")
    h[b] = 0
    h[hl.clamp(inp[r.x, r.y], 0, bins - 1)] += 1
    h.distribute(r.y, "shards")
    return hl.Pipeline(h)


def _train_step(hl, mesh, rng, dev, lr: float = 1e-2):
    """One SGD step of relu(conv) on a ("data", "model") mesh, against the
    same step unsharded -> what was checked."""
    from ..eval_torch import contract_precision
    from ..pipeline import gather_graph

    N, CI, CO, Wi, Hi = 4, 8, 8, 16, 8
    x, y, c, n = hl.Var("x"), hl.Var("y"), hl.Var("c"), hl.Var("n")
    inp = hl.ImageParam(hl.Float(32), 4, "tr_in")
    wts = hl.ImageParam(hl.Float(32), 4, "tr_w")
    bias = hl.ImageParam(hl.Float(32), 1, "tr_b")
    r = hl.RDom(0, CI, 0, 3, 0, 3, "tr_r")
    conv = hl.Func("tr_conv")
    conv[c, x, y, n] = bias[c]
    conv[c, x, y, n] += wts[c, r.y, r.z, r.x] * inp[r.x, x + r.y, y + r.z, n]
    relu = hl.Func("tr_relu")
    relu[c, x, y, n] = hl.max(0.0, conv[c, x, y, n])
    pipe = hl.Pipeline(relu)

    def t(a):
        return torch.from_numpy(a).to(dev)

    xd = t(rng.standard_normal((N, Hi + 2, Wi + 2, CI)).astype(np.float32))
    wd = t((rng.standard_normal((CI, 3, 3, CO)) * 0.1).astype(np.float32))
    bd = t(np.zeros(CO, np.float32))
    tgt = t(rng.standard_normal((N, Hi, Wi, CO)).astype(np.float32))
    runs = {}

    def step(xb, w, b, target):
        """relu(conv) forward and backward on one shard's tensors ->
        (squared error summed over the shard / the global count, dL/dw,
        dL/db)."""
        key = (str(xb.device), tuple(xb.shape), tuple(w.shape))
        if key not in runs:
            inp.set(xb)
            wts.set(w)
            bias.set(b)
            g = gather_graph(pipe.outputs)
            regions = pipe._out_regions([w.shape[3], Wi, Hi, xb.shape[0]])
            objs = pipe._inputs(g)
            runs[key] = ([id(o) for o, _b in objs], pipe._build_fn(
                g, regions, objs, {}, xb.device))
        order, run = runs[key]
        w = w.detach().clone().requires_grad_()
        b = b.detach().clone().requires_grad_()
        by_id = {id(inp): xb, id(wts): w, id(bias): b}
        with torch.enable_grad(), contract_precision():
            (pred,), = run([by_id[k] for k in order])
            loss = ((pred - target) ** 2).sum() / tgt.numel()
            gw, gb = torch.autograd.grad(loss, [w, b])
        return loss.detach(), gw, gb

    # the unsharded step
    loss_1, gw_1, gb_1 = step(xd, wd, bd, tgt)
    w_1, b_1 = wd - lr * gw_1, bd - lr * gb_1

    # the sharded step: shard (i, j) takes batch slice i and output
    # channels j
    D, M = mesh.shape["data"], mesh.shape["model"]
    xs = torch.tensor_split(xd, D, dim=0)
    ts = [torch.tensor_split(tt, M, dim=3)
          for tt in torch.tensor_split(tgt, D, dim=0)]
    ws = torch.tensor_split(wd, M, dim=3)
    bs = torch.tensor_split(bd, M, dim=0)
    grid = mesh.devices
    losses, new_w, new_b = [], [], []
    for j in range(M):
        col = [grid[i, j] for i in range(D)]
        parts = [step(xs[i].to(col[i]), ws[j].to(col[i]),
                      bs[j].to(col[i]), ts[i][j].to(col[i]))
                 for i in range(D)]
        losses += [p[0] for p in parts]
        # weight gradients combined over "data", in shard order
        gw = combine([p[1] for p in parts], "add", col[0])
        gb = combine([p[2] for p in parts], "add", col[0])
        new_w.append((ws[j].to(col[0]) - lr * gw).to(dev))
        new_b.append((bs[j].to(col[0]) - lr * gb).to(dev))
    w_n = torch.cat(new_w, dim=3)
    b_n = torch.cat(new_b, dim=0)
    loss_n = combine(losses, "add", dev)
    np.testing.assert_allclose(w_n.cpu().numpy(), w_1.cpu().numpy(),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(b_n.cpu().numpy(), b_1.cpu().numpy(),
                               rtol=1e-5, atol=1e-7)
    if not torch.isfinite(loss_n):
        raise AssertionError("training loss is not finite")
    return {"mesh": dict(mesh.shape), "loss": float(loss_n),
            "loss_unsharded": float(loss_1),
            "max_abs_dw": float((w_n - w_1).abs().max())}
