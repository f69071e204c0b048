"""Reduction domains (reference: src/RDom.h:29,193, src/RDom.cpp)."""
from __future__ import annotations

from typing import List, Optional

from . import expr as E
from .expr import CompileError, Expr, to_expr
from .htypes import Int

__all__ = ["RVar", "RDom"]


class RVar(E.Variable):
    """A reduction variable: a Variable that carries its domain."""
    __slots__ = ("rmin", "rextent", "rdom")

    _counter = [0]

    def __init__(self, mn=None, extent=None, name: Optional[str] = None):
        if name is None:
            RVar._counter[0] += 1
            name = f"r{RVar._counter[0]}$x"
        super().__init__(name, Int(32))
        self.rmin = to_expr(mn, hint=Int(32)) if mn is not None else None
        self.rextent = to_expr(extent, hint=Int(32)) if extent is not None else None
        self.rdom: Optional["RDom"] = None

    def __setattr__(self, name, value):
        # a bound set again (`rdom` is set last in __init__) changes what
        # the graph walk reads: bump the definition epoch
        if name in ("rmin", "rextent") and hasattr(self, "rdom"):
            from .func import definitions_changed
            definitions_changed()
        super().__setattr__(name, value)

    def min(self) -> Expr:
        return self.rmin

    def extent(self) -> Expr:
        return self.rextent


_RDOM_AXES = ["x", "y", "z", "w"]


class RDom:
    """Multi-dimensional reduction domain with optional predicates.

    RDom(min0, extent0[, min1, extent1, ...]) or RDom([(min, extent), ...]) or
    RDom(buffer_or_imageparam) covering its whole domain.
    `where(pred)` attaches predicates (reference: src/RDom.h:270-320).
    """

    _counter = [0]

    def __init__(self, *args, name: Optional[str] = None):
        if args and isinstance(args[-1], str) and name is None:
            name = args[-1]
            args = args[:-1]
        if name is None:
            RDom._counter[0] += 1
            name = f"r{RDom._counter[0]}"
        self.name = name
        self.predicates: List[Expr] = []
        ranges: List[tuple] = []
        if len(args) == 1 and isinstance(args[0], (list, tuple)):
            ranges = list(args[0])
        elif len(args) == 1 and hasattr(args[0], "dimensions"):
            b = args[0]
            for i in range(b.dimensions()):
                d = b.dim(i)
                if callable(getattr(d, "min", None)):
                    ranges.append((d.min(), d.extent()))
                else:
                    ranges.append((d.min, d.extent))
        else:
            if len(args) % 2 != 0:
                raise CompileError("RDom needs (min, extent) pairs")
            ranges = [(args[i], args[i + 1]) for i in range(0, len(args), 2)]
        self.dims: List[RVar] = []
        for i, (mn, ex) in enumerate(ranges):
            axis = _RDOM_AXES[i] if i < 4 else str(i)
            rv = RVar(mn, ex, name=f"{name}${axis}")
            rv.rdom = self
            self.dims.append(rv)

    # named accessors
    @property
    def x(self) -> RVar:
        return self.dims[0]

    @property
    def y(self) -> RVar:
        return self.dims[1]

    @property
    def z(self) -> RVar:
        return self.dims[2]

    @property
    def w(self) -> RVar:
        return self.dims[3]

    def __getitem__(self, i: int) -> RVar:
        return self.dims[i]

    def __len__(self) -> int:
        return len(self.dims)

    def where(self, pred) -> "RDom":
        from .func import definitions_changed
        self.predicates.append(to_expr(pred))
        definitions_changed()       # the graph walk reads the predicates
        return self

    def min(self) -> Expr:
        return self.x.rmin

    def extent(self) -> Expr:
        return self.x.rextent

    # A 1-D RDom can be used directly as an index expression.
    def _to_expr(self) -> Expr:
        if len(self.dims) != 1:
            raise CompileError(
                f"RDom {self.name} is {len(self.dims)}-D; index with .x/.y/...")
        return self.dims[0]

    # arithmetic sugar for the 1-D case
    def __add__(self, o):
        return self._to_expr() + o

    def __radd__(self, o):
        return o + self._to_expr()

    def __sub__(self, o):
        return self._to_expr() - o

    def __rsub__(self, o):
        return o - self._to_expr()

    def __mul__(self, o):
        return self._to_expr() * o

    def __rmul__(self, o):
        return o * self._to_expr()

    def __neg__(self):
        return -self._to_expr()

    def __repr__(self):
        parts = ", ".join(f"[{d.rmin!r}, {d.rextent!r}]" for d in self.dims)
        return f"RDom({self.name}: {parts})"


def collect_rdom(exprs) -> Optional[RDom]:
    """Find the unique RDom referenced by a definition (args + values).

    The reference allows at most one RDom per definition
    (reference: src/Definition.h — a definition has one ReductionDomain)."""
    from .visitors import walk
    found: List[RDom] = []

    def fn(n):
        if isinstance(n, RVar) and n.rdom is not None:
            if all(r is not n.rdom for r in found):
                found.append(n.rdom)

    for e in exprs:
        if isinstance(e, Expr):
            walk(e, fn)
    if not found:
        return None
    if len(found) > 1:
        raise CompileError(
            "a definition may use at most one RDom; found "
            + ", ".join(r.name for r in found))
    return found[0]
