"""specialize(): schedule-variant ladders (reference: src/Func.h:406-407,
1770-1842). Each specialization is an independently schedulable variant
chosen by a param-dependent condition compiled as an if/else-if chain.

In the port each realize resolves the ladders before it plans or runs: the
conditions are evaluated in declaration order with the realize's param
values and inputs, the first true variant wins, and specialize_fail raises.
The chosen variants are part of the plan-cache key (beside the param values
and input shapes, which pin every other value a condition can read), and
their recorded directives are REPLAYED onto the stage's real schedule
around every run of the plan (and restored afterwards), so the bounds, the
group kernel's plan and the evaluation all see the variant. A condition
that cannot be resolved to one value (it references loop Vars) is a
CompileError, matching the reference's requirement that specialization
conditions depend only on parameters.
"""
from __future__ import annotations

from typing import List

from .expr import CompileError, Expr, to_expr
from .func import definitions_changed


class Specialization:
    def __init__(self, func, stage_index: int, condition: Expr):
        self.func = func
        self.stage_index = stage_index
        self.condition = condition
        self.failure_message = None
        self.directives: List[tuple] = []

    # accept and record any scheduling directive applied to the variant
    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)

        def record(*a, **kw):
            self.directives.append((name, a, kw))
            return self

        return record

    def apply(self):
        """Replay the recorded directives onto the live schedule."""
        from .func import Stage
        if self.stage_index == 0:
            target = self.func          # Func-level API incl. compute_root
        else:
            target = Stage(self.func, self.stage_index)
        for (name, a, kw) in self.directives:
            m = getattr(target, name, None)
            if m is None:
                raise CompileError(
                    f"specialization of {self.func.name} uses unknown "
                    f"directive {name!r}")
            m(*a, **kw)


def add_specialization(func, stage_index: int, cond) -> Specialization:
    cond = to_expr(cond)
    if not cond.dtype.is_bool():
        raise CompileError("specialize() condition must be boolean")
    s = Specialization(func, stage_index, cond)
    func._specializations.append(s)
    definitions_changed()       # the walk reads the condition
    return s


def add_specialize_fail(func, stage_index: int, msg: str) -> None:
    s = Specialization(func, stage_index, to_expr(True))
    s.failure_message = msg
    func._specializations.append(s)
    definitions_changed()


def _reads_data(e: Expr) -> bool:
    from . import expr as E
    from .visitors import walk
    found = []
    walk(e, lambda n: isinstance(n, E.Call) and found.append(n))
    return bool(found)


def select(g, realizations, param_vals, device):
    """Evaluate every func's specialization ladder with the realize's
    param/input bindings and return the chosen variants, first true wins
    per func. A condition that reads input data is evaluated on `device`
    (a read back from the card); the others on the CPU."""
    from .eval_torch import Ctx, eval_array

    chosen = []
    for f in g.funcs:
        specs = getattr(f, "_specializations", [])
        if not specs:
            continue
        for s in specs:
            dev = device if _reads_data(s.condition) else "cpu"
            try:
                v = eval_array(s.condition, Ctx(0, {}, {}, realizations,
                                                param_vals, dev))
                taken = bool(v)
            except Exception as e:
                raise CompileError(
                    f"specialize() condition on {f.name} is not statically "
                    f"resolvable at compile time: {e}")
            if not taken:
                continue
            if s.failure_message is not None:
                raise CompileError(
                    f"specialize_fail on {f.name}: {s.failure_message}")
            chosen.append(s)
            break
    return chosen


def apply_all(chosen):
    """Apply the chosen variants' directives; returns the undo list."""
    undo = []
    for s in chosen:
        f = s.func
        undo.append((f._fschedule, f._fschedule.snapshot()))
        for d in f._defs:
            undo.append((d.schedule, d.schedule.snapshot()))
        s.apply()
    return undo


def restore(undo):
    for obj, snap in reversed(undo):
        obj.restore(snap)
