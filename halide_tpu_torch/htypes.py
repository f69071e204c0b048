"""Scalar type system.

Mirrors the reference's Type lattice (reference: src/Type.h:296-332): int/uint
{8,16,32,64}, float {16,32,64}, bfloat16, bool, handle. Vector lanes are NOT part
of the type here: evaluation is whole-array, so types are scalar element types
only.

Each Type maps to a torch dtype twice over: its storage dtype (what a Buffer
holds) and its compute dtype (what evaluation uses). They differ for the
unsigned types torch cannot compute with on the CPU (add, compare, shift,
floor-div and min raise for uint16/uint32/uint64): u16 is evaluated in int32
and u32 in int64, re-wrapped with a mask after every op that can overflow, u64
in int64 as the same bits, and each is cast to the storage dtype only at
buffers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "Type", "Int", "UInt", "Float", "BFloat", "Bool", "Handle",
    "type_of", "match_types", "torch_dtype", "compute_dtype",
]


@dataclasses.dataclass(frozen=True)
class Type:
    code: str   # 'int' | 'uint' | 'float' | 'bfloat' | 'handle'
    bits: int

    # ---- classification ------------------------------------------------
    def is_int(self) -> bool:
        return self.code == "int"

    def is_uint(self) -> bool:
        return self.code == "uint"

    def is_integer(self) -> bool:
        return self.code in ("int", "uint")

    def is_float(self) -> bool:
        return self.code in ("float", "bfloat")

    def is_bool(self) -> bool:
        return self.code == "uint" and self.bits == 1

    def is_handle(self) -> bool:
        return self.code == "handle"

    # ---- numpy/torch interop -------------------------------------------
    def to_np(self):
        if self.is_bool():
            return np.dtype(np.bool_)
        if self.code == "int":
            return np.dtype(f"int{self.bits}")
        if self.code == "uint":
            return np.dtype(f"uint{self.bits}")
        if self.code == "float":
            return np.dtype(f"float{self.bits}")
        raise ValueError(f"no numpy dtype for {self} (bfloat16 lives in "
                         "torch only: use torch_dtype)")

    # ---- ranges ----------------------------------------------------------
    def min_value(self):
        if self.is_bool():
            return False
        if self.code == "uint":
            return 0
        if self.code == "int":
            return -(1 << (self.bits - 1))
        return -np.inf

    def max_value(self):
        if self.is_bool():
            return True
        if self.code == "uint":
            return (1 << self.bits) - 1
        if self.code == "int":
            return (1 << (self.bits - 1)) - 1
        return np.inf

    def can_represent(self, v) -> bool:
        if self.is_float():
            return True
        if isinstance(v, float) and not float(v).is_integer():
            return False
        return self.min_value() <= v <= self.max_value()

    def __repr__(self):
        if self.is_bool():
            return "Bool()"
        return f"{self.code}{self.bits}"

    def short_name(self) -> str:
        if self.is_bool():
            return "b1"
        c = {"int": "i", "uint": "u", "float": "f", "bfloat": "bf"}[self.code]
        return f"{c}{self.bits}"


def Int(bits: int = 32) -> Type:
    return Type("int", bits)


def UInt(bits: int = 32) -> Type:
    return Type("uint", bits)


def Float(bits: int = 32) -> Type:
    return Type("float", bits)


def BFloat(bits: int = 16) -> Type:
    return Type("bfloat", bits)


def Bool() -> Type:
    return Type("uint", 1)


def Handle() -> Type:
    return Type("handle", 64)


_NP_TO_TYPE = None


def type_of(dtype) -> Type:
    """Map a numpy or torch dtype to a framework Type."""
    global _NP_TO_TYPE
    if _NP_TO_TYPE is None:
        _NP_TO_TYPE = {np.dtype(np.bool_): Bool(), torch.bool: Bool(),
                       torch.bfloat16: BFloat(16)}
        for b in (8, 16, 32, 64):
            _NP_TO_TYPE[np.dtype(f"int{b}")] = Int(b)
            _NP_TO_TYPE[np.dtype(f"uint{b}")] = UInt(b)
            _NP_TO_TYPE[getattr(torch, f"int{b}")] = Int(b)
            _NP_TO_TYPE[getattr(torch, f"uint{b}")] = UInt(b)
        for b in (16, 32, 64):
            _NP_TO_TYPE[np.dtype(f"float{b}")] = Float(b)
            _NP_TO_TYPE[getattr(torch, f"float{b}")] = Float(b)
    if isinstance(dtype, torch.dtype):
        return _NP_TO_TYPE[dtype]
    return _NP_TO_TYPE[np.dtype(dtype)]


def torch_dtype(t: Type) -> torch.dtype:
    """Storage dtype of a Type: what a Buffer holds."""
    if t.is_bool():
        return torch.bool
    if t.code == "bfloat":
        return torch.bfloat16
    if t.code in ("int", "uint", "float"):
        return getattr(torch, f"{t.code}{t.bits}")
    raise ValueError(f"no torch dtype for {t}")


_COMPUTE_WIDER = {16: torch.int32, 32: torch.int64, 64: torch.int64}


def compute_dtype(t: Type) -> torch.dtype:
    """Dtype evaluation computes a Type in: the storage dtype, except u16
    (int32), u32 and u64 (int64), whose torch arithmetic is missing on the
    CPU. u64 is held as two's-complement int64: the same bits, with the
    operations that read them as unsigned (compare, min, max, division,
    right shift, conversion to and from float) written out in eval_torch."""
    if t.is_uint() and t.bits in _COMPUTE_WIDER:
        return _COMPUTE_WIDER[t.bits]
    return torch_dtype(t)


def match_types(ta: Type, tb: Type) -> Type:
    """Binary-operator type unification.

    Follows the reference's match_types rules (reference: src/IROperator.cpp
    match_types): floats win and take the wider float; mixed-signedness integers
    become signed at the wider width; bools promote to the other side.
    """
    if ta == tb:
        return ta
    if ta.is_handle() or tb.is_handle():
        raise TypeError("arithmetic on handle types")
    if ta.is_bool():
        return tb
    if tb.is_bool():
        return ta
    a_f, b_f = ta.is_float(), tb.is_float()
    if a_f and b_f:
        # bfloat16 + float16 -> float32; otherwise wider wins
        if ta.code != tb.code:
            if ta.bits == tb.bits:
                return Float(2 * ta.bits)
            return ta if ta.bits > tb.bits else tb
        return ta if ta.bits >= tb.bits else tb
    if a_f:
        return ta
    if b_f:
        return tb
    bits = max(ta.bits, tb.bits)
    if ta.code == tb.code:
        return Type(ta.code, bits)
    return Int(bits)
