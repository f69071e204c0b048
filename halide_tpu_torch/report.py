"""Pipeline HTML report -- the stmt_html analog (reference:
src/StmtToHTML.cpp + irvisualizer): pipeline graph, definitions, schedules,
inferred regions, and the lowering each stage took. A tiled consumer's
lowering line names the stencil-group kernel's last plan for it (sub-tile,
threads a block, shared memory, grid), or the reason the plan rejected its
schedule, in which case the group runs whole-array."""
from __future__ import annotations

import html

from .loopnest import loop_nest_str
from .pipeline import gather_graph

_CSS = """
body { font-family: monospace; background: #1e1e2e; color: #cdd6f4; }
h1, h2 { color: #89b4fa; }
.func { border: 1px solid #45475a; margin: 8px; padding: 8px;
        border-radius: 6px; background: #181825; }
.name { color: #a6e3a1; font-weight: bold; }
.sched { color: #f9e2af; }
.expr { color: #cdd6f4; white-space: pre-wrap; }
.meta { color: #9399b2; font-size: 90%; }
.lowering { color: #f38ba8; }
table { border-collapse: collapse; }
td, th { border: 1px solid #45475a; padding: 2px 8px; }
"""

# the fields of a group plan's record the lowering line names
_PLAN_FIELDS = ("sub_tile", "threads", "smem_bytes", "grid")


def lowering_line(f, g) -> str:
    """The lowering of a tiled consumer f: the group kernel, its staged
    producers, and its last plan or reject reason ("" for an untiled f)."""
    from .ops.group_kernel import (find_tile, group_members, plans_by_name,
                                   rejects_by_name)
    tile = find_tile(f)
    if tile is None:
        return ""
    mem = group_members(f, g)
    out = (f"group kernel: tile {tile} + {len(mem)} staged producer(s)"
           f" [{', '.join(m.name for m in mem)}]")
    plan = plans_by_name.get(f.name)
    if plan is not None:
        out += "; last plan: " + ", ".join(f"{k}={plan[k]}"
                                           for k in _PLAN_FIELDS)
    elif f.name in rejects_by_name:
        out += (f"; rejected ({rejects_by_name[f.name]}): evaluated "
                "whole-array")
    return out


def pipeline_report_html(pipeline, sizes=None) -> str:
    g = gather_graph(pipeline.outputs)
    parts = ["<html><head><style>", _CSS, "</style></head><body>"]
    parts.append("<h1>halide_tpu_torch pipeline report</h1>")
    parts.append(
        f"<p class=meta>outputs: "
        f"{', '.join(f.name for f in pipeline.outputs)} | "
        f"{len(g.funcs)} funcs ({len(g.materialized)} materialized) | "
        f"{len(g.inputs)} inputs | {len(g.params)} params</p>")

    boxes = {}
    if sizes is not None:
        # per-func inferred regions from a fresh bounds pass (display only)
        from .bounds import BoundsEngine
        from .pipeline import _BoundsPass
        bp = _BoundsPass(g, BoundsEngine())
        bp.run(pipeline.outputs, pipeline._out_regions(sizes))
        boxes = bp.boxes

    for f in g.funcs:
        mat = id(f) in g.materialized
        parts.append("<div class=func>")
        stage = "materialized" if mat else "inlined (evaluated in its readers)"
        lower = lowering_line(f, g) if mat else ""
        parts.append(
            f"<div><span class=name>{html.escape(f.name)}</span>"
            f" <span class=meta>({stage})</span></div>")
        for i, d in enumerate(f._defs):
            kind = "pure" if i == 0 else f"update {i - 1}"
            argstr = ", ".join(repr(a) for a in d.args)
            for vi, v in enumerate(d.values):
                sfx = f"[{vi}]" if len(d.values) > 1 else ""
                parts.append(
                    f"<div class=expr>{kind}: {html.escape(f.name)}"
                    f"({html.escape(argstr)}){sfx} = "
                    f"{html.escape(repr(v))}</div>")
            dims = " ".join(f"{dm.var}:{dm.for_type.value}"
                            for dm in d.schedule.dims)
            if d.schedule.splits:
                splits = "; ".join(
                    f"{s.kind}({s.old}->{s.outer},{s.inner},{s.factor})"
                    for s in d.schedule.splits)
                parts.append(f"<div class=sched>splits: "
                             f"{html.escape(splits)}</div>")
            parts.append(f"<div class=sched>loops: {html.escape(dims)}</div>")
            for (other, var, align) in d.schedule.fused_with:
                astr = ", ".join(f"{k}:{a.value}" for k, a in align.items())
                parts.append(
                    f"<div class=sched>compute_with: "
                    f"{html.escape(other[0].name)} at {html.escape(var)}"
                    f" [{html.escape(astr)}]</div>")
        lvl = f._fschedule.compute_level
        parts.append(f"<div class=sched>compute: {html.escape(repr(lvl))}"
                     f"</div>")
        box = boxes.get(id(f))
        if box is not None and box.defined():
            ext = ", ".join(f"[{iv.lo}, {iv.hi}]" for iv in box.dims)
            parts.append(f"<div class=meta>inferred region: "
                         f"{html.escape(ext)}</div>")
        if lower:
            parts.append(f"<div class=lowering>{html.escape(lower)}</div>")
        parts.append("</div>")

    parts.append("<h2>loop nest</h2><pre>")
    for f in pipeline.outputs:
        parts.append(html.escape(loop_nest_str(f)))
    parts.append("</pre></body></html>")
    return "".join(parts)
