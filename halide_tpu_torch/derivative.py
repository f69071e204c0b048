"""Autodiff (reference: src/Derivative.cpp propagate_adjoints -- 2,000 LoC of
hand-rolled reverse mode; src/autoschedulers/li2018 consumes the result),
the counterpart of the JAX package's derivative.py.

The port's realize is an eager torch program, so reverse mode is
`torch.autograd.grad` through the realize executor (pipeline._build_fn).
API mirrors propagate_adjoints: gradients of a scalar reduction of the
output (optionally weighted by an adjoint buffer) with respect to float
ImageParams and Params.

The kernels launch through ctypes, which autograd cannot see. The JAX
package differentiates through its Pallas kernels (a tiled group, a scan),
so each kernel on a path that carries a gradient goes through a
`torch.autograd.Function`: K1 (group_kernel._GroupGrad) launches the
kernel forward and recomputes its plain version with a graph backward; the
scan K2 (scan_kernel._ScanGrad) is differentiated by a scan in the other
direction, through the same wrapper. K3's counts take integer bins and a
constant weight: no gradient passes through them, as none does through the
JAX kernel's. On the CPU the same Functions run the plain versions, so the
card and the CPU take one path.
"""
from __future__ import annotations

import numpy as np
import torch

from .buffer import ImageParam, Param
from .expr import CompileError
from .hooks import to_numpy
from .htypes import torch_dtype
from .pipeline import Pipeline, gather_graph, resolve_device


def propagate_adjoints(output, adjoint=None, sizes=None, wrt=None,
                       device=None):
    """-> dict name -> gradient (a numpy array), for each float input in
    `wrt` (default: every float ImageParam/Param in the pipeline), realized
    on `device` (None: the card).

    adjoint: array matching the realized output (default: ones -- i.e.
    gradients of sum(output))."""
    from .specialize import apply_all, restore, select
    from .eval_torch import Realized

    pipeline = output if isinstance(output, Pipeline) else Pipeline(output)
    if sizes is None:
        raise CompileError("propagate_adjoints needs realize sizes")
    dev = resolve_device(device)
    g = gather_graph(pipeline.outputs)
    if wrt is None:
        wrt = [t for t in g.inputs.values()
               if isinstance(t, ImageParam) and t.type.is_float()] + \
              [p for p in g.params.values() if p.type.is_float()]
    order = [id(t) for t in g.inputs.values()]
    for w in wrt:
        if isinstance(w, ImageParam):
            if id(w) not in order:
                raise CompileError(
                    f"{w.name} is not an input of the pipeline")
        elif not isinstance(w, Param):
            raise CompileError(f"cannot differentiate w.r.t. {w!r}")

    regions = pipeline._out_regions(sizes)
    input_objs = pipeline._inputs(g)
    inp = [buf.data.to(dev) for (_, buf) in input_objs]
    param_vals = {id(p): p.get() for p in g.params.values()}
    leaves = []
    traced = {}
    for w in wrt:
        if isinstance(w, ImageParam):
            k = order.index(id(w))
            inp[k] = inp[k].detach().clone().requires_grad_()
            leaves.append(inp[k])
        else:
            t = torch.tensor(w.get(), dtype=torch_dtype(w.type), device=dev,
                             requires_grad=True)
            traced[id(w)] = t
            leaves.append(t)

    chosen = []
    if any(f._specializations for f in g.funcs):
        chosen = select(g, {
            id(t): Realized((a.detach(),), buf._mins,
                            getattr(t, "name", "buf"))
            for (t, buf), a in zip(input_objs, inp)}, param_vals, dev)
    undo = apply_all(chosen)
    try:
        presets = pipeline._memo_precompute(g, input_objs, param_vals,
                                            regions, dev)
        run = pipeline._build_fn(g, regions, input_objs, param_vals, dev)
        adj = None
        if adjoint is not None:
            adj = torch.as_tensor(np.asarray(adjoint, np.float32),
                                  device=dev)
        with torch.enable_grad():
            outs = run(inp, presets, True, traced)
            total = torch.zeros((), dtype=torch.float32, device=dev)
            for per_func in outs:
                for arr in per_func:
                    a2 = arr.to(torch.float32)
                    if adj is not None:
                        a2 = a2 * adj
                    total = total + a2.sum()
            grads = [None] * len(leaves)
            if total.requires_grad:
                grads = torch.autograd.grad(total, leaves,
                                            allow_unused=True)
    finally:
        restore(undo)
    # an input the output does not depend on gets zeros, as jax.grad gives
    return {w.name: to_numpy(gr if gr is not None
                             else torch.zeros_like(leaf.detach()))
            for w, leaf, gr in zip(wrt, leaves, grads)}
