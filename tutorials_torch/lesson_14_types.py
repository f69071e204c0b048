"""Lesson 14: the type system (reference: tutorial/lesson_14_types.cpp).

Types are (code, bits): Int/UInt/Float/Bool plus bfloat16. The
reference's promotion rules apply: binary ops unify operand types, casts
are explicit via hl.u8/u16/i32/f32/..., and saturating_cast clamps
instead of wrapping.
"""
import numpy as np
import halide_tpu_torch as hl


def main(device=None):
    x = hl.Var("x")

    # type objects
    assert hl.Int(32).bits == 32
    assert hl.UInt(16).is_uint() and not hl.UInt(16).is_float()
    assert hl.Float(32).is_float()
    assert hl.BFloat(16).bits == 16

    # expression types follow the reference's unification rules
    u8 = hl.u8(3)
    assert (u8 + u8).dtype == hl.UInt(8)          # same-type stays
    assert (u8 + hl.u16(1)).dtype == hl.UInt(16)  # widen to the wider
    assert (hl.f32(1.0) + u8).dtype == hl.Float(32)  # float wins

    # wrapping vs saturating casts
    f = hl.Func("l14_wrap")
    f[x] = hl.u8(x * 32)                  # 8*32 = 256 wraps to 0
    g = hl.Func("l14_sat")
    g[x] = hl.saturating_cast(hl.UInt(8), x * 32)   # clamps at 255
    fo = f.realize([16], device=device).to_numpy()
    go = g.realize([16], device=device).to_numpy()
    assert fo[8] == 0 and go[8] == 255
    assert fo.dtype == np.uint8 and go.dtype == np.uint8

    # bfloat16: a storage type of its own; contractions accumulate f32
    h = hl.Func("l14_bf16")
    h[x] = hl.cast(hl.BFloat(16), hl.f32(x) * 0.5)
    hb = h.realize([8], device=device)
    assert str(hb.data.dtype) == "torch.bfloat16"
    # numpy has no bfloat16: to_numpy() widens it to float32, exactly
    assert hb.to_numpy().tolist() == [v * 0.5 for v in range(8)]
    print("lesson 14: types OK", fo[:9].tolist(), go[:9].tolist())


if __name__ == "__main__":
    main()
