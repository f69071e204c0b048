"""print_loop_nest (reference: src/PrintLoopNest.cpp): a human-readable sketch
of the schedule-implied loop structure. The text is the JAX package's, word
for word (its loop marks included: a GPU block loop prints as "grid", a
thread loop as "lanes"), so the two packages print the same nest for the
same pipeline."""
from __future__ import annotations

from typing import List

from .func import Func
from .pipeline import gather_graph
from .schedule import ForType

_MARK = {
    ForType.SERIAL: "for", ForType.PARALLEL: "parallel",
    ForType.VECTORIZED: "vectorized", ForType.UNROLLED: "unrolled",
    ForType.GPU_BLOCK: "grid", ForType.GPU_THREAD: "lanes",
}


def loop_nest_str(out: Func) -> str:
    g = gather_graph([out])
    lines: List[str] = []
    for f in g.funcs:
        if id(f) not in g.materialized:
            continue
        lvl = f._fschedule.compute_level
        where = ("root" if not lvl.defined() or lvl.is_root()
                 else f"at {lvl.func.name}.{getattr(lvl.var, 'name', lvl.var)}")
        lines.append(f"produce {f.name} ({where}):")
        for si, d in enumerate(f._defs):
            indent = "  "
            prefix = "" if si == 0 else f"{indent}update {si - 1}:\n"
            if prefix:
                lines.append(prefix.rstrip("\n"))
            depth = 1
            for dim in reversed(d.schedule.dims):
                kind = _MARK[dim.for_type]
                rtag = " (rvar)" if dim.is_rvar else ""
                lines.append("  " * depth + f"{kind} {f.name}.{dim.var}{rtag}:")
                depth += 1
            lines.append("  " * depth + f"{f.name}(...) = ...")
    return "\n".join(lines)


def print_loop_nest(out: Func) -> None:
    print(loop_nest_str(out))
