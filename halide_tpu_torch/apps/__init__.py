"""The apps of this slice, on the port (counterparts of the JAX package's
apps). Each app module exposes

    build(**params) -> App    with .pipeline, .inputs, .make_inputs(seed),
                              .reference(numpy inputs) -> numpy golden,
                              .output_sizes

and registers itself in APPS. The arithmetic and make_inputs(seed) are those
of the JAX apps, so both packages get the same inputs from the same seed.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, Optional

import numpy as np
import torch

APPS: Dict[str, Callable] = {}

_APP_MODULES = ["blur", "linear_blur", "iir_blur", "hist", "interpolate",
                "local_laplacian", "stencil_chain", "camera_pipe", "unsharp",
                "harris", "wavelet", "gaussian_blur", "max_filter", "nl_means",
                "conv_layer", "linear_algebra", "fft", "compositing",
                "bilateral_grid", "bgu", "resize", "lens_blur",
                "resnet_50", "granite_4_h_micro"]


def register(name: str):
    def deco(fn):
        APPS[name] = fn
        return fn
    return deco


def load_all() -> Dict[str, Callable]:
    for m in _APP_MODULES:
        importlib.import_module(f"halide_tpu_torch.apps.{m}")
    return APPS


def get(name: str):
    if name not in APPS:
        load_all()
    return APPS[name]


# The producers that a tiled schedule of an app computes at its output's
# tiles (`tile_producers`): the JAX apps take no tile, so the schedule is put
# on from outside, the same code for both packages' pipelines.
TILED_PRODUCERS = {"unsharp": ("gray", "blur_y"),
                   "harris": ("gray", "Ix", "Iy")}


def tile_producers(m, pipeline, tile, producers) -> None:
    """Tile `pipeline`'s output over its first two dims (x, y) by `tile`
    and compute the Funcs named in `producers` at its x tiles, in place of
    their own compute level. `m` is the package the pipeline was built with:
    this one, or the JAX package in the tests, whose Funcs and `gather_graph`
    take the same calls. Call it before the pipeline's first realize."""
    out = pipeline.outputs[0]
    funcs = {f.name: f for f in m.pipeline.gather_graph([out]).funcs}
    x, y = out.args()[:2]
    xo, yo, xi, yi = m.Var("xo"), m.Var("yo"), m.Var("xi"), m.Var("yi")
    out.tile(x, y, xo, yo, xi, yi, tile[0], tile[1])
    for name in producers:
        funcs[name].compute_at(out, xo)


def inputs_from_numpy(app: "App", data: dict, device) -> dict:
    """The one move of an app's inputs from the numpy dict of
    make_inputs(seed) onto `device`: image inputs become contiguous tensors
    there, scalar Params stay Python values."""
    from ..buffer import ImageParam
    out = {}
    for spec in app.inputs:
        v = data[spec.name]
        if isinstance(spec, ImageParam):
            v = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        out[spec.name] = v
    return out


class App:
    """One pipeline instance with its inputs and golden."""

    def __init__(self, name, pipeline, inputs, make_inputs, reference,
                 output_sizes, megapixels: Optional[float] = None,
                 tolerance: float = 0.0, atol: Optional[float] = None,
                 mismatch_frac: float = 0.0, flops: Optional[float] = None):
        self.name = name
        self.pipeline = pipeline        # halide_tpu_torch.Pipeline
        self.inputs = inputs            # list[ImageParam/Param]
        self.make_inputs = make_inputs  # (seed) -> dict name->np array/scalar
        self.reference = reference      # (**np inputs) -> np array
        self.output_sizes = output_sizes
        self.megapixels = megapixels or _mp(output_sizes)
        self.tolerance = tolerance      # rtol; 0 => bit-exact
        self.atol = atol if atol is not None else tolerance
        self.mismatch_frac = mismatch_frac
        # useful operations a frame (a multiply-add is 2) of a contraction
        # app, for the rate `chip_smoke.py` prints
        self.flops = flops

    def bind(self, data: dict, device=None):
        """Bind the numpy dict of make_inputs(seed) (or tensors) to the
        inputs, on the realize device: None means the card."""
        from ..pipeline import resolve_device
        for name, v in inputs_from_numpy(self, data,
                                         resolve_device(device)).items():
            next(s for s in self.inputs if s.name == name).set(v)

    def realize(self, device=None):
        return self.pipeline.realize(self.output_sizes, device=device)


def _mp(sizes) -> float:
    mp = 1.0
    for s in sizes[:2]:
        mp *= s
    return mp / 1e6
