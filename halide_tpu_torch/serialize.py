"""Pipeline serialization: JSON round-trip of the whole pipeline graph
including schedules (reference: src/Serialization.cpp + halide_ir.fbs ->
.hlpipe, tutorial/lesson_23). The text is the JAX package's, format 1,
field for field: each package reads what the other writes. A deserialized
pipeline plans its groups and kernels anew on its first realize.

Not carried by the text (the same in both packages): the store level is
written but not read back; a Func's debug_to_file name, no_profiling,
memoize eviction key and distribute() record, a bound's modulus and
remainder (align_bounds), a storage dim's fold direction and a stage's
rfactor origin are neither written nor read."""
from __future__ import annotations

import json
from typing import Dict, List

from . import expr as E
from .buffer import ImageParam, Param
from .expr import CompileError, Expr
from .func import Definition, Func, Var, definitions_changed
from .htypes import Type
from .rdom import RDom, RVar
from .schedule import (Bound, Dim, ForType, LoopLevel, Split, StageSchedule,
                       StorageDim, TailStrategy)

FORMAT_VERSION = 1


class _Ser:
    def __init__(self):
        self.funcs: Dict[int, str] = {}
        self.func_defs: List[dict] = []
        self.images: Dict[int, dict] = {}
        self.params: Dict[int, dict] = {}
        self.rdoms: Dict[int, dict] = {}

    def type_(self, t: Type):
        return [t.code, t.bits]

    def expr(self, e) -> dict:
        if isinstance(e, E.IntImm):
            return {"k": "int", "t": self.type_(e.dtype), "v": e.value}
        if isinstance(e, E.FloatImm):
            return {"k": "float", "t": self.type_(e.dtype), "v": e.value}
        if isinstance(e, E.StringImm):
            return {"k": "str", "v": e.value}
        if isinstance(e, RVar):
            return {"k": "rvar", "name": e.name}
        if isinstance(e, E.Variable):
            return {"k": "var", "name": e.name}
        if isinstance(e, E.Cast):
            return {"k": "cast", "t": self.type_(e.dtype),
                    "v": self.expr(e.value)}
        if isinstance(e, E.Reinterpret):
            return {"k": "reinterpret", "t": self.type_(e.dtype),
                    "v": self.expr(e.value)}
        if isinstance(e, E.Binary):
            return {"k": "bin", "op": e.op, "a": self.expr(e.a),
                    "b": self.expr(e.b), "t": self.type_(e.dtype)}
        if isinstance(e, E.Not):
            return {"k": "not", "a": self.expr(e.a)}
        if isinstance(e, E.Select):
            return {"k": "select", "c": self.expr(e.cond),
                    "a": self.expr(e.true_value),
                    "b": self.expr(e.false_value)}
        if isinstance(e, E.Call):
            t = e.target
            if isinstance(t, Func):
                tgt = {"func": self.func(t)}
            elif isinstance(t, ImageParam):
                tgt = {"image": self.image(t)}
            else:
                raise CompileError(
                    "cannot serialize a pipeline holding concrete Buffers; "
                    "use ImageParams for inputs")
            return {"k": "call", "tgt": tgt,
                    "args": [self.expr(a) for a in e.args],
                    "idx": e.value_index}
        if isinstance(e, E.Intrin):
            args = []
            for a in e.args:
                if isinstance(a, Expr):
                    args.append({"e": self.expr(a)})
                elif isinstance(a, Param):
                    args.append({"param": self.param(a)})
                elif isinstance(a, ImageParam):
                    args.append({"image": self.image(a)})
                else:
                    args.append({"raw": a})
            return {"k": "intrin", "name": e.name,
                    "t": self.type_(e.dtype), "args": args}
        if isinstance(e, E.Let):
            return {"k": "let", "name": e.name, "v": self.expr(e.value),
                    "b": self.expr(e.body)}
        if isinstance(e, E.Reduce):
            return {"k": "reduce", "op": e.op, "v": self.expr(e.value),
                    "rdom": self.rdom(e.rdom),
                    "w": self.expr(e.where) if e.where is not None else None,
                    "idx": e.value_index, "t": self.type_(e.dtype)}
        raise CompileError(f"cannot serialize {type(e).__name__}")

    def rdom(self, rd) -> str:
        key = f"rdom{id(rd)}"
        if key not in self.rdoms:
            self.rdoms[key] = None  # placeholder to stop recursion
            self.rdoms[key] = {
                "name": rd.name,
                "dims": [{"name": rv.name, "min": self.expr(rv.rmin),
                          "extent": self.expr(rv.rextent)}
                         for rv in rd.dims],
                "preds": [self.expr(p2) for p2 in rd.predicates],
            }
        return key

    def image(self, ip: ImageParam) -> str:
        key = f"img{id(ip)}"
        if key not in self.images:
            self.images[key] = {"name": ip.name, "type": self.type_(ip.type),
                                "dims": ip.dimensions()}
        return key

    def param(self, pa: Param) -> str:
        key = f"param{id(pa)}"
        if key not in self.params:
            self.params[key] = {"name": pa.name, "type": self.type_(pa.type)}
        return key

    def func(self, fn: Func) -> str:
        key = f"f{id(fn)}"
        if key in self.funcs:
            return key
        self.funcs[key] = None   # reserve
        defs = []
        for d in fn._defs:
            defs.append({
                "args": [self.expr(a) for a in d.args],
                "values": [self.expr(v) for v in d.values],
                "rdom": self.rdom(d.rdom) if d.rdom is not None else None,
                "preds": [self.expr(p2) for p2 in d.predicates],
                "schedule": self.stage_schedule(d.schedule),
            })
        fs = fn._fschedule
        entry = {
            "key": key,
            "name": fn.name,
            "defs": defs,
            "schedule": {
                "compute": self.loop_level(fs.compute_level),
                "store": self.loop_level(fs.store_level),
                "bounds": [[b.var,
                            self.expr(b.min) if b.min is not None else None,
                            self.expr(b.extent) if b.extent is not None
                            else None] for b in fs.bounds],
                "estimates": [[b.var,
                               self.expr(b.min) if b.min is not None
                               else None,
                               self.expr(b.extent) if b.extent is not None
                               else None] for b in fs.estimates],
                "memoized": fs.memoized,
                "async": fs.is_async,
                "ring_buffer": fs.ring_buffer_extent,
                "storage_dims": [[sd.var, sd.fold_factor]
                                 for sd in fs.storage_dims],
                "trace": [fs.trace_loads, fs.trace_stores,
                          fs.trace_realizations],
                "tags": fs.tags,
            },
        }
        self.funcs[key] = entry
        return key

    def loop_level(self, lvl: LoopLevel):
        if not lvl.defined():
            return None
        if lvl.is_inlined():
            return "inline"
        if lvl.is_root():
            return "root"
        return {"func": self.func(lvl.func),
                "var": getattr(lvl.var, "name", str(lvl.var))}

    def stage_schedule(self, s: StageSchedule):
        return {
            "splits": [[sp.old, sp.outer, sp.inner,
                        sp.factor if isinstance(sp.factor, (int, type(None)))
                        else self.expr(sp.factor),
                        sp.kind, sp.tail.value] for sp in s.splits],
            "dims": [[d.var, d.for_type.value, d.is_rvar] for d in s.dims],
            "atomic": s.atomic,
            "allow_races": s.allow_races,
            "fused": [[self.func(other[0]), other[1], var,
                       {k: a.value for k, a in align.items()}]
                      for (other, var, align) in s.fused_with],
        }


def serialize_pipeline(pipeline) -> str:
    s = _Ser()
    outs = [s.func(f) for f in pipeline.outputs]
    doc = {
        "format": FORMAT_VERSION,
        "outputs": outs,
        "funcs": s.funcs,
        "images": s.images,
        "params": s.params,
        "rdoms": s.rdoms,
    }
    return json.dumps(doc, indent=1)


class _Des:
    def __init__(self, doc):
        self.doc = doc
        self.funcs: Dict[str, Func] = {}
        self.images: Dict[str, ImageParam] = {}
        self.params: Dict[str, Param] = {}
        self.rvars: Dict[str, RVar] = {}
        self.rdoms: Dict[str, RDom] = {}
        # hash-consing of the expressions read: a subtree that occurs more
        # than once in the text (the JSON spells out every use of a shared
        # node) becomes one node again, so that the evaluator and the group
        # kernel compute it once, as they do for the pipeline that was
        # written
        self._ids: Dict[tuple, int] = {}
        self._cid: Dict[int, int] = {}
        self._nodes: Dict[int, Expr] = {}
        for key, meta in doc.get("images", {}).items():
            t = Type(meta["type"][0], meta["type"][1])
            self.images[key] = ImageParam(t, meta["dims"], meta["name"])
        for key, meta in doc.get("params", {}).items():
            t = Type(meta["type"][0], meta["type"][1])
            self.params[key] = Param(t, meta["name"])
        for key in doc.get("rdoms", {}):
            self._rdom(key)

    def _rdom(self, key) -> RDom:
        if key in self.rdoms:
            return self.rdoms[key]
        meta = self.doc["rdoms"][key]
        rd = RDom.__new__(RDom)
        rd.name = meta["name"]
        rd.predicates = []
        rd.dims = []
        self.rdoms[key] = rd
        for dm in meta["dims"]:
            rv = RVar.__new__(RVar)
            E.Variable.__init__(rv, dm["name"], E.Int(32))
            rv.rmin = self.expr(dm["min"])
            rv.rextent = self.expr(dm["extent"])
            rv.rdom = rd
            rd.dims.append(rv)
            self.rvars[rv.name] = rv
        rd.predicates = [self.expr(p2) for p2 in meta["preds"]]
        return rd

    def type_(self, t):
        return Type(t[0], t[1])

    def _canon(self, v) -> int:
        """A small int, the same for equal JSON values, built bottom-up
        (each key holds its children's ints, so hashing stays flat)."""
        if isinstance(v, (dict, list)):
            c = self._cid.get(id(v))
            if c is not None:
                return c
            if isinstance(v, dict):
                key = ("d",) + tuple(sorted(
                    (k, self._canon(x)) for k, x in v.items()))
            else:
                key = ("l",) + tuple(self._canon(x) for x in v)
            c = self._cid[id(v)] = self._ids.setdefault(key, len(self._ids))
            return c
        return self._ids.setdefault(("s", type(v).__name__, repr(v)),
                                    len(self._ids))

    def expr(self, d) -> Expr:
        c = self._canon(d)
        e = self._nodes.get(c)
        if e is None:
            e = self._nodes[c] = self._expr(d)
        return e

    def _expr(self, d) -> Expr:
        k = d["k"]
        if k == "int":
            return E.IntImm(self.type_(d["t"]), d["v"])
        if k == "float":
            return E.FloatImm(self.type_(d["t"]), d["v"])
        if k == "str":
            return E.StringImm(d["v"])
        if k == "rvar":
            return self.rvars[d["name"]]
        if k == "var":
            return E.Variable(d["name"])
        if k == "cast":
            return E.Cast(self.type_(d["t"]), self.expr(d["v"]))
        if k == "reinterpret":
            return E.Reinterpret(self.type_(d["t"]), self.expr(d["v"]))
        if k == "bin":
            return E.Binary(d["op"], self.expr(d["a"]), self.expr(d["b"]),
                            self.type_(d["t"]))
        if k == "not":
            return E.Not(self.expr(d["a"]))
        if k == "select":
            return E.Select(self.expr(d["c"]), self.expr(d["a"]),
                            self.expr(d["b"]))
        if k == "call":
            tgt = d["tgt"]
            if "func" in tgt:
                target = self.func(tgt["func"])
            else:
                target = self.images[tgt["image"]]
            return E.Call(target, [self.expr(a) for a in d["args"]],
                          d["idx"])
        if k == "intrin":
            args = []
            for a in d["args"]:
                if "e" in a:
                    args.append(self.expr(a["e"]))
                elif "param" in a:
                    args.append(self.params[a["param"]])
                elif "image" in a:
                    args.append(self.images[a["image"]])
                else:
                    args.append(a["raw"])
            return E.Intrin(d["name"], self.type_(d["t"]), args)
        if k == "let":
            return E.Let(d["name"], self.expr(d["v"]), self.expr(d["b"]))
        if k == "reduce":
            return E.Reduce(d["op"], self.expr(d["v"]),
                            self._rdom(d["rdom"]),
                            self.expr(d["w"]) if d["w"] else None,
                            d["idx"], self.type_(d["t"]))
        raise CompileError(f"bad serialized expr kind {k!r}")

    def func(self, key) -> Func:
        if key in self.funcs:
            return self.funcs[key]
        meta = self.doc["funcs"][key]
        fn = Func(meta["name"])
        self.funcs[key] = fn
        for di, dmeta in enumerate(meta["defs"]):
            args = tuple(self.expr(a) for a in dmeta["args"])
            if di == 0:
                args = tuple(Var(a.name) for a in args)
            values = tuple(self.expr(v) for v in dmeta["values"])
            rdom = self._rdom(dmeta["rdom"]) if dmeta["rdom"] else None
            pure_args = tuple(
                a.name for a in (fn._args if di else args)
                if isinstance(a, E.Variable))
            d = Definition(args, values, rdom,
                           [self.expr(p2) for p2 in dmeta["preds"]],
                           tuple(v.name for v in args)
                           if di == 0 else ())
            if di == 0:
                fn._args = args
            self._apply_stage_schedule(d.schedule, dmeta["schedule"])
            fn._defs.append(d)
            definitions_changed()
        self._apply_func_schedule(fn, meta["schedule"])
        return fn

    def _apply_stage_schedule(self, s: StageSchedule, meta):
        s.splits = [Split(a, b, c, f if isinstance(f, (int, type(None)))
                          else self.expr(f), kind, TailStrategy(tail))
                    for a, b, c, f, kind, tail in meta["splits"]]
        s.dims = [Dim(v, ForType(ft), rv) for v, ft, rv in meta["dims"]]
        s.atomic = meta["atomic"]
        s.allow_races = meta["allow_races"]
        from .schedule import LoopAlignStrategy
        for rec in meta.get("fused", []):
            fkey, fidx, var, align = rec
            s.fused_with.append(
                ((self.func(fkey), fidx), var,
                 {k: LoopAlignStrategy(v) for k, v in align.items()}))

    def _apply_func_schedule(self, fn: Func, meta):
        fs = fn._fschedule
        lvl = meta["compute"]
        if lvl == "inline":
            fs.compute_level = LoopLevel.inlined()
        elif lvl == "root":
            fs.compute_level = LoopLevel.root()
        elif isinstance(lvl, dict):
            fs.compute_level = LoopLevel(self.func(lvl["func"]),
                                         Var(lvl["var"]))
        for var, mn, ex in meta["bounds"]:
            fs.bounds.append(Bound(var,
                                   self.expr(mn) if mn else None,
                                   self.expr(ex) if ex else None))
        for var, mn, ex in meta["estimates"]:
            fs.estimates.append(Bound(var,
                                      self.expr(mn) if mn else None,
                                      self.expr(ex) if ex else None))
        fs.memoized = meta["memoized"]
        fs.is_async = meta["async"]
        fs.ring_buffer_extent = meta["ring_buffer"]
        for var, fold in meta["storage_dims"]:
            fs.storage_dims.append(StorageDim(var, fold))
        fs.trace_loads, fs.trace_stores, fs.trace_realizations = meta["trace"]
        fs.tags = meta["tags"]


def deserialize_pipeline(text: str):
    """-> (Pipeline, {name: ImageParam}, {name: Param})"""
    from .pipeline import Pipeline
    doc = json.loads(text)
    if doc.get("format") != FORMAT_VERSION:
        raise CompileError("unsupported pipeline format version")
    des = _Des(doc)
    outs = [des.func(k) for k in doc["outputs"]]
    images = {ip.name: ip for ip in des.images.values()}
    params = {pa.name: pa for pa in des.params.values()}
    return Pipeline(outs), images, params
