"""Generators: declarative AOT pipeline classes + registry
(reference: src/Generator.h:238-252 HALIDE_REGISTER_GENERATOR,
generate_filter_main @ Generator.cpp:663,974; driven by tools/gen.py -- the
GenGen.cpp analog), the counterpart of the JAX package's generator.py.

A generator is a Python class with declared GeneratorParams / inputs /
outputs and a generate() method; `create` builds it with param settings,
and `emit_artifacts` writes what the build CLI asks for: the serialized
pipeline (hlpipe), the loop nest (stmt), the HTML report (stmt_html),
metadata, a standalone runnable source (pysource) and an exported program
(object: `export_compiled`, a `torch.export` program whose kernels are the
port's custom ops, ops/export_ops.py).
"""
from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Dict, List, Optional

import torch

from .buffer import ImageParam, Param
from .expr import CompileError
from .func import Func
from .htypes import Type
from .pipeline import Pipeline

_REGISTRY: Dict[str, type] = {}


class GeneratorParam:
    """Typed, string-settable from the build CLI (reference:
    src/Generator.h:402-672)."""

    def __init__(self, default, name: Optional[str] = None):
        self.default = default
        self.name = name

    def parse(self, s: str):
        t = type(self.default)
        if t is bool:
            return s.lower() in ("1", "true", "yes")
        if t is int:
            return int(s)
        if t is float:
            return float(s)
        if isinstance(self.default, tuple):
            return tuple(int(v) for v in s.split(","))
        return s


class Generator:
    """Base class. Subclasses declare GeneratorParam class attributes and
    implement generate(self) -> Func | Pipeline, creating inputs via
    self.input_buffer(...) / self.input_scalar(...)."""

    name: str = ""

    def __init__(self, **param_values):
        self.inputs: List = []
        self._gp: Dict[str, GeneratorParam] = {}
        for k in dir(type(self)):
            v = getattr(type(self), k)
            if isinstance(v, GeneratorParam):
                self._gp[k] = v
                setattr(self, k, param_values.get(k, v.default))
        for k, v in param_values.items():
            if k not in self._gp:
                raise CompileError(
                    f"{self.name}: unknown GeneratorParam {k!r}")

    # ---- input declaration helpers --------------------------------------
    def input_buffer(self, name: str, type: Type, dims: int) -> ImageParam:
        ip = ImageParam(type, dims, name)
        self.inputs.append(ip)
        return ip

    def input_scalar(self, name: str, type: Type, default=None) -> Param:
        p = Param(type, name, default)
        self.inputs.append(p)
        return p

    def generate(self):
        raise NotImplementedError

    def build_pipeline(self) -> Pipeline:
        out = self.generate()
        if isinstance(out, Func):
            out = Pipeline(out)
        if isinstance(out, (list, tuple)):
            out = Pipeline(list(out))
        return out


def register_generator(name: str):
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def generator_names() -> List[str]:
    _load_app_generators()
    return sorted(_REGISTRY)


def _load_app_generators():
    """Every registered app of the port doubles as a generator (the
    reference's apps are all generators)."""
    from .apps import APPS, load_all
    load_all()
    for name, builder in APPS.items():
        if name in _REGISTRY:
            continue

        def make_cls(builder=builder, name=name):
            class AppGenerator(Generator):
                def __init__(self, **params):
                    self._params = params
                    self.inputs = []
                    self._gp = {}

                def build_pipeline(self):
                    app = builder(**self._params)
                    self.inputs = app.inputs
                    self._app = app
                    return app.pipeline
            AppGenerator.name = name
            return AppGenerator

        _REGISTRY[name] = make_cls()


def create(name: str, **params) -> Generator:
    _load_app_generators()
    if name not in _REGISTRY:
        raise CompileError(
            f"unknown generator {name!r}; have {generator_names()}")
    return _REGISTRY[name](**params)


# ---------------------------------------------------------------------------
# artifact emission (reference: Module::compile output types, Module.h:26-47)
# ---------------------------------------------------------------------------

def emit_artifacts(gen: Generator, out_dir: str, fn_name: str,
                   emits: List[str], sizes=None,
                   device=None) -> Dict[str, str]:
    """Write each artifact of `emits` to out_dir/fn_name.*; -> {emit: path}
    (or {emit + "_error": message} for one that could not be made). The
    lowered program of pysource and the object are made on `device` (None:
    the card) at `sizes`: an app's generator binds the app's inputs of
    seed 0, any other input left unbound is zero-filled."""
    os.makedirs(out_dir, exist_ok=True)
    pipeline = gen.build_pipeline()
    written: Dict[str, str] = {}
    app = getattr(gen, "_app", None)
    if sizes is not None and app is not None and \
            ("object" in emits or "pysource" in emits):
        # an app's generator binds the app's inputs (seed 0): a pipeline
        # whose bounds depend on its data (hist) needs them
        from .pipeline import resolve_device
        app.bind(app.make_inputs(0), resolve_device(device))

    def path(ext):
        return os.path.join(out_dir, f"{fn_name}.{ext}")

    if "hlpipe" in emits or "object" in emits:
        from .serialize import serialize_pipeline
        try:
            text = serialize_pipeline(pipeline)
            with open(path("hlpipe"), "w") as f:
                f.write(text)
            written["hlpipe"] = path("hlpipe")
        except CompileError as e:
            written["hlpipe_error"] = str(e)

    if "stmt" in emits:
        from .loopnest import loop_nest_str
        with open(path("stmt"), "w") as f:
            for out in pipeline.outputs:
                f.write(loop_nest_str(out) + "\n")
        written["stmt"] = path("stmt")

    if "stmt_html" in emits:
        from .report import pipeline_report_html
        with open(path("stmt.html"), "w") as f:
            f.write(pipeline_report_html(pipeline, sizes))
        written["stmt_html"] = path("stmt.html")

    if "c_header" in emits or "metadata" in emits:
        meta = {
            "name": fn_name,
            "inputs": [
                {"name": getattr(i, "name", "?"),
                 "kind": "buffer" if isinstance(i, ImageParam) else "scalar",
                 "type": repr(getattr(i, "type", None)),
                 "dims": i.dimensions() if isinstance(i, ImageParam)
                 else 0}
                for i in gen.inputs],
            "outputs": len(pipeline.outputs),
        }
        with open(path("metadata.json"), "w") as f:
            json.dump(meta, f, indent=1)
        written["metadata"] = path("metadata.json")

    if "pysource" in emits:
        # readable-source output (the CodeGen_C analog, reference:
        # src/CodeGen_C.cpp / compile_to_c): a standalone runnable .py that
        # rebuilds the pipeline from its serialized graph, plus, with sizes,
        # the lowered program as a comment appendix
        from .serialize import serialize_pipeline
        try:
            graph_json = serialize_pipeline(pipeline)
            lowered = (lowered_program(pipeline, sizes, device)
                       if sizes is not None else "")
            src = (
                '"""Generated by halide_tpu_torch (-e pysource): standalone '
                f'runnable source for {fn_name!r}.\n'
                'Rebuilds the pipeline from its serialized graph and '
                'realizes it with bound inputs.\n"""\n'
                "from halide_tpu_torch.serialize import "
                "deserialize_pipeline\n\n"
                f"GRAPH = r'''{graph_json}'''\n\n\n"
                "def pipeline():\n"
                "    return deserialize_pipeline(GRAPH)\n\n\n"
                "def run(sizes, device=None, **inputs):\n"
                "    p, imgs, params = pipeline()\n"
                "    for name, v in inputs.items():\n"
                "        (imgs.get(name) or params[name]).set(v)\n"
                "    return p.realize(sizes, device=device)\n"
                + ("\n\n# ---- lowered program ----\n"
                   + "".join(f"# {ln}\n" for ln in lowered.splitlines())
                   if lowered else ""))
            with open(path("py"), "w") as f:
                f.write(src)
            written["pysource"] = path("py")
        except CompileError as e:
            written["pysource_error"] = str(e)

    if "object" in emits:
        # the exported program of the whole pipeline at the given sizes
        # (the analog of the compiled object + registration)
        if sizes is None:
            raise CompileError("-e object needs explicit sizes=WxH[xC...]")
        try:
            blob = export_compiled(pipeline, sizes, device)
            with open(path("exported"), "wb") as f:
                f.write(blob)
            written["object"] = path("exported")
        except CompileError as e:
            written["object_error"] = str(e)
    return written


def _bind_zeros(pipeline: Pipeline, sizes, dev) -> None:
    """Zero-filled buffers on dev for the unbound ImageParams, sized to
    their required regions (Pipeline.infer_input_bounds)."""
    from .pipeline import gather_graph
    g = gather_graph(pipeline.outputs)
    if any(isinstance(t, ImageParam) and t._bound is None
           for t in g.inputs.values()):
        pipeline.infer_input_bounds(sizes, device=dev)


def _planned_run(pipeline: Pipeline, sizes, dev):
    """-> (run, input tensors, the plans as (plan, windows' realized mins,
    params), [(input, its Buffer)]): the realize executor of the
    pipeline at `sizes` on dev (pipeline._build_fn), run once with every
    group planned and none computed (group_kernel.planning), so that the
    plans are fixed before a program is traced. Raises for what an
    exported program cannot hold: an extern stage (a host callback), a
    memoized stage (a host cache) or a specialization ladder (one branch
    would be frozen)."""
    from .ops import group_kernel
    from .pipeline import gather_graph
    g = gather_graph(pipeline.outputs)
    for f in g.funcs:
        why = ("an extern stage" if f.is_extern() else
               "memoized" if f._fschedule.memoized else
               "specialized" if f._specializations else None)
        if why:
            raise CompileError(f"cannot export {f.name}: {why}")
    _bind_zeros(pipeline, sizes, dev)
    regions = pipeline._out_regions(sizes)
    input_objs = pipeline._inputs(g)
    inp = [buf.data.to(dev) for (_, buf) in input_objs]
    param_vals = {id(p): p.get() for p in g.params.values()}
    run = pipeline._build_fn(g, regions, input_objs, param_vals, dev)
    plans = []
    with group_kernel.planning(lambda *a: plans.append(a)):
        run(inp)
    return run, inp, plans, input_objs


def lowered_program(pipeline: Pipeline, sizes, device=None) -> str:
    """The port's lowered program of the pipeline at `sizes` (pysource's
    appendix): each materialized stage's lowering as the report names it,
    then each group's plan and its emitted K1 source."""
    from .pipeline import gather_graph, resolve_device
    from .report import lowering_line
    dev = resolve_device(device)
    _run, _inp, plans, _objs = _planned_run(pipeline, sizes, dev)
    g = gather_graph(pipeline.outputs)
    lines = []
    for f in g.funcs:
        if id(f) in g.materialized:
            lines.append(f"{f.name}: {lowering_line(f, g) or 'whole-array'}")
    for plan, _mins, _params in plans:
        lines.append("")
        lines.append(f"group {plan.f.name}: {plan.record()}")
        lines += plan.source.splitlines()
    return "\n".join(lines)


class _Program(torch.nn.Module):
    """The realize executor as a module: forward(*inputs) -> the outputs'
    tensors, flattened (each output's values in order)."""

    def __init__(self, run):
        super().__init__()
        self.run = run

    def forward(self, *inputs):
        return tuple(a for per in self.run(list(inputs)) for a in per)


def export_compiled(pipeline: Pipeline, sizes, device=None) -> bytes:
    """Export the realize executor at `sizes` on `device` (None: the card)
    with torch.export; -> the artifact's bytes, reloadable with
    load_compiled(). The program calls the kernels as the port's custom
    ops (ops/export_ops.py) and embeds shapes and dtypes. The artifact is a
    zip of the exported program, the pipeline's text (from which the loader
    plans the groups again and emits their K1 sources) and meta.json, which
    names the build key of every K1 launch."""
    from .ops import export_ops
    from .pipeline import resolve_device
    from .serialize import serialize_pipeline
    dev = resolve_device(device)
    text = serialize_pipeline(pipeline)
    run, inp, plans, input_objs = _planned_run(pipeline, sizes, dev)
    with export_ops.export_mode():      # registers each plan it traces
        ep = torch.export.export(_Program(run), tuple(inp), strict=False)
    ep.example_inputs = None     # the inputs' bytes stay out of the file
    prog = io.BytesIO()
    torch.export.save(ep, prog)
    meta = {"sizes": list(sizes), "device": dev.type,
            "inputs": [{"name": getattr(t, "name", "?"),
                        "shape": list(a.shape), "dtype": str(a.dtype)}
                       for (t, _b), a in zip(input_objs, inp)],
            "kernels": {export_ops.group_key(p): p.symbol
                        for p, _m, _q in plans}}
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w") as z:
        z.writestr("meta.json", json.dumps(meta, indent=1))
        z.writestr("pipeline.hlpipe", text)
        z.writestr("program.pt2", prog.getvalue())
    return out.getvalue()


def load_compiled(blob: bytes):
    """Load an artifact of export_compiled on the device it was exported
    for; -> fn(*input tensors) -> the outputs' tensors (a tuple). The
    groups are planned again from the pipeline's text (the plain version
    on the CPU needs the plan; on the card the kernel is built into
    build/kernels/ at its first launch), and every K1 source the program
    names must come out the same."""
    from .ops import export_ops
    from .serialize import deserialize_pipeline
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        meta = json.loads(z.read("meta.json"))
        text = z.read("pipeline.hlpipe").decode()
        prog = z.read("program.pt2")
    pipe, images, _params = deserialize_pipeline(text)
    dev = torch.device(meta["device"])
    for spec in meta["inputs"]:
        images[spec["name"]].set(torch.zeros(
            spec["shape"], dtype=getattr(torch, spec["dtype"].split(".")[-1]),
            device=dev))
    _run, _inp, plans, _objs = _planned_run(pipe, meta["sizes"], dev)
    got = {}
    for plan, real_mins, params in plans:
        key = export_ops.group_key(plan)
        got[key] = plan.symbol
        export_ops.plans[key] = (plan, real_mins, params)
    for key, symbol in meta["kernels"].items():
        if got.get(key) != symbol:
            raise CompileError(
                f"exported program names group {key}, which the pipeline's "
                f"text plans as {got.get(key)}")
    mod = torch.export.load(io.BytesIO(prog)).module()

    def call(*inputs):
        return tuple(mod(*inputs))
    return call
