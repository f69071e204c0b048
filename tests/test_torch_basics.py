"""Front-end and realize basics, and the expected compile errors, in both
packages: the cases of tests/test_basics.py and tests/test_errors.py, each
built the same way in the port (realized on the CPU) and in the JAX
package, held against numpy and against each other (bit for bit; the
libm case within rtol 1e-6: the two libms differ by an ulp). An error case
must raise the package's CompileError in both. The rfactor error case
(test_errors.py:120) is in tests/test_torch_reductions.py, with the port's
rfactor."""
import numpy as np
import pytest

import halide_tpu as hl
import halide_tpu_torch as ht


def _realize(m, f, sizes=None, **kw):
    """Realize a Func (or Pipeline) in package m: on the CPU for the port."""
    if m is ht:
        kw["device"] = "cpu"
    return f.realize(sizes, **kw)


def _np(r):
    if isinstance(r, (list, tuple)) or type(r).__name__ == "Realization":
        return [np.asarray(b.to_numpy()) for b in r]
    return np.asarray(r.to_numpy())


# ---------------------------------------------------------------------------
# tests/test_basics.py: each case(m) builds and realizes in package m and
# returns the output(s) and numpy's
# ---------------------------------------------------------------------------

def gradient(m):
    x, y = m.Var("x"), m.Var("y")
    f = m.Func("grad")
    f[x, y] = x + y
    return _realize(m, f, [4, 3]), np.add.outer(np.arange(3), np.arange(4))


def types_and_cast(m):
    x = m.Var("x")
    f = m.Func()
    f[x] = m.cast(m.UInt(8), x * 3)
    return _realize(m, f, [200]), (np.arange(200) * 3 % 256).astype(np.uint8)


def uint8_wraparound(m):
    x = m.Var("x")
    f = m.Func()
    f[x] = m.u8(x) + m.u8(250)
    return _realize(m, f, [20]), np.arange(20, dtype=np.uint8) + np.uint8(250)


def euclidean_div_mod(m):
    x = m.Var("x")
    f = m.Func()
    f[x] = m.Tuple((x - 10) / 3, (x - 10) % 3)
    xs = np.arange(20) - 10
    return _realize(m, f, [20]), [xs // 3, xs % 3]


def div_by_zero_is_zero(m):
    x = m.Var("x")
    f = m.Func()
    f[x] = 7 / (x - 2) + 100 % (x - 2)
    xs = np.arange(3) - 2
    safe = np.where(xs == 0, 1, xs)
    return _realize(m, f, [3]), np.where(xs == 0, 0,
                                         7 // safe + 100 % safe)


def select_clamp(m):
    x = m.Var("x")
    f = m.Func()
    f[x] = m.select(x < 5, m.clamp(x, 2, 3), 99)
    return _realize(m, f, [8]), np.array([2, 2, 2, 3, 3, 99, 99, 99])


def multiway_select(m):
    x = m.Var("x")
    f = m.Func()
    f[x] = m.select(x == 0, 10, x == 1, 20, 30)
    return _realize(m, f, [3]), np.array([10, 20, 30])


def inline_producer_consumer(m):
    x, y = m.Var("x"), m.Var("y")
    p, c = m.Func("p"), m.Func("c")
    p[x, y] = x * y
    c[x, y] = p[x, y] + p[x + 1, y]
    xs, ys = np.arange(4), np.arange(4)[:, None]
    return _realize(m, c, [4, 4]), xs * ys + (xs + 1) * ys


def compute_root_same_result(m):
    x, y = m.Var("x"), m.Var("y")
    p, c = m.Func("p"), m.Func("c")
    p[x, y] = x * 2 + y
    p.compute_root()
    c[x, y] = p[x, y] * 3
    return _realize(m, c, [5, 5]), (np.arange(5) * 2
                                    + np.arange(5)[:, None]) * 3


def stencil_needs_bigger_producer_region(m):
    x, y = m.Var("x"), m.Var("y")
    p, c = m.Func("p"), m.Func("c")
    p[x, y] = x + y * 10
    p.compute_root()
    c[x, y] = p[x, y] + p[x + 2, y]
    xs, ys = np.arange(5), np.arange(5)[:, None]
    return _realize(m, c, [5, 5]), (xs + 10 * ys) + (xs + 2 + 10 * ys)


def input_buffer_and_boundary(m):
    x, y = m.Var("x"), m.Var("y")
    data = np.arange(12, dtype=np.float32).reshape(3, 4)
    clamped = m.repeat_edge(m.Buffer(data, name="in"))
    f = m.Func()
    f[x, y] = clamped[x - 1, y] + clamped[x + 1, y]
    padded = np.pad(data, ((0, 0), (1, 1)), mode="edge")
    return _realize(m, f, [4, 3]), padded[:, :-2] + padded[:, 2:]


def math_ops(m):
    x = m.Var("x")
    f = m.Func()
    f[x] = m.sqrt(m.f32(x)) + m.exp(m.f32(x) * 0.1)
    xs = np.arange(10, dtype=np.float32)
    return _realize(m, f, [10]), np.sqrt(xs) + np.exp(xs * np.float32(0.1))


def tuple_func(m):
    x = m.Var("x")
    f = m.Func("tup")
    f[x] = (x + 1, m.f32(x) * 0.5)
    return _realize(m, f, [4]), [np.arange(4) + 1, np.arange(4) * 0.5]


def param(m):
    x = m.Var("x")
    p = m.Param(m.Int(32), "offset")
    f = m.Func()
    f[x] = x + p
    p.set(5)
    first = _np(_realize(m, f, [3]))
    p.set(9)
    return [first, _np(_realize(m, f, [3]))], [np.array([5, 6, 7]),
                                               np.array([9, 10, 11])]


def imageparam(m):
    x = m.Var("x")
    img = m.ImageParam(m.Float(32), 1, "img")
    f = m.Func()
    f[x] = img[x] * 2.0
    img.set(np.arange(5, dtype=np.float32))
    return _realize(m, f, [5]), np.arange(5, dtype=np.float32) * 2


def nonzero_min_buffer(m):
    x = m.Var("x")
    data = np.arange(4, dtype=np.int32)
    inp = m.Buffer(data).set_min(10)
    f = m.Func()
    f[x] = inp[m.clamp(x, 10, 13)]
    return _realize(m, f, [20]), data[np.clip(np.arange(20), 10, 13) - 10]


def widening_saturating(m):
    x = m.Var("x")
    f = m.Func()
    f[x] = m.saturating_add(m.u8(x * 20), m.u8(100))
    return _realize(m, f, [13]), np.minimum(
        np.arange(13) * 20 % 256 + 100, 255).astype(np.uint8)


def lerp(m):
    x = m.Var("x")
    f = m.Func()
    f[x] = m.lerp(0.0, 10.0, m.f32(x) / 9.0)
    return _realize(m, f, [10]), np.linspace(0, 10, 10)


def strided_and_reversed_access(m):
    x = m.Var("x")
    data = np.arange(16, dtype=np.int32)
    inp = m.Buffer(data)
    f = m.Func()
    f[x] = inp[x * 2] + inp[15 - x]
    return _realize(m, f, [8]), data[::2] + data[15:7:-1]


def func_of_func_diagonal(m):
    x, y = m.Var("x"), m.Var("y")
    p = m.Func("p")
    p[x, y] = x * 10 + y
    p.compute_root()
    f = m.Func()
    f[x] = p[x, x]
    return _realize(m, f, [4]), np.array([0, 11, 22, 33])


BASICS = [gradient, types_and_cast, uint8_wraparound, euclidean_div_mod,
          div_by_zero_is_zero, select_clamp, multiway_select,
          inline_producer_consumer, compute_root_same_result,
          stencil_needs_bigger_producer_region, input_buffer_and_boundary,
          math_ops, tuple_func, param, imageparam, nonzero_min_buffer,
          widening_saturating, lerp, strided_and_reversed_access,
          func_of_func_diagonal]
# the float cases compared within a tolerance: libm (math_ops), and the
# lerp against linspace's arithmetic
INEXACT = {"math_ops": 1e-6, "lerp": 1e-6}


@pytest.mark.parametrize("case", BASICS, ids=lambda c: c.__name__)
def test_basics_match_jax_and_numpy(case):
    got, want = case(ht)
    ref, _ = case(hl)
    got, ref = _np(got) if not isinstance(got, list) else got, \
        _np(ref) if not isinstance(ref, list) else ref
    outs = got if isinstance(got, list) else [got]
    refs = ref if isinstance(ref, list) else [ref]
    wants = want if isinstance(want, list) else [want]
    tol = INEXACT.get(case.__name__)
    for g, r, w in zip(outs, refs, wants):
        g = np.asarray(g)
        assert g.dtype == np.asarray(r).dtype
        if tol is None:
            np.testing.assert_array_equal(g, r)
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, r, rtol=tol)
            np.testing.assert_allclose(g, w, rtol=tol, atol=1e-6)


# ---------------------------------------------------------------------------
# the error cases: tests/test_basics.py's two and tests/test_errors.py's;
# each case(m) must raise m.CompileError (from building or realizing)
# ---------------------------------------------------------------------------

def out_of_bounds_input(m):
    x = m.Var("x")
    f = m.Func()
    f[x] = m.Buffer(np.arange(4, dtype=np.float32))[x + 1]
    _realize(m, f, [4])


def undefined_func(m):
    x = m.Var("x")
    f, g = m.Func("undefined_f"), m.Func()
    g[x] = f[x] + 1
    _realize(m, g, [4])


def inline_func_with_updates(m):
    x = m.Var("x")
    f = m.Func("e_f")
    f[x] = 0
    f[x] += 1
    f.compute_inline()
    g = m.Func("e_g")
    g[x] = f[x]
    _realize(m, g, [4])


def pure_def_requires_vars(m):
    x = m.Var("x")
    m.Func("e_p")[x + 1] = 0


def duplicate_pure_vars(m):
    x = m.Var("x")
    m.Func("e_d")[x, x] = 0


def two_rdoms_in_definition(m):
    f, x = m.Func("e_r"), m.Var("x")
    r1, r2 = m.RDom(0, 3), m.RDom(0, 4)
    f[x] = 0
    f[x] += r1.x + r2.x


def adorned_pure_var_in_update(m):
    f, x = m.Func("e_a"), m.Var("x")
    f[x] = 0
    f[x + 1] = f[x] + 1


def update_arity_mismatch(m):
    f = m.Func("e_ar")
    x, y = m.Var("x"), m.Var("y")
    f[x, y] = 0
    f[x] = 1


def wrong_call_arity(m):
    f = m.Func("e_c")
    x, y = m.Var("x"), m.Var("y")
    f[x, y] = x + y
    m.Func("e_c2")[x] = f[x]


def realize_undefined(m):
    _realize(m, m.Func("e_u"), [4])


def unbound_imageparam(m):
    x = m.Var("x")
    img = m.ImageParam(m.Float(32), 1, "e_img")
    f = m.Func("e_ub")
    f[x] = img[x]
    img.reset()
    _realize(m, f, [4])


def unset_param(m):
    x = m.Var("x")
    p = m.Param(m.Int(32), "e_param")
    f = m.Func("e_up")
    f[x] = x + p
    _realize(m, f, [4])


def bound_too_small(m):
    x = m.Var("x")
    f = m.Func("e_b")
    f[x] = x
    f.bound(x, 0, 8)
    _realize(m, f, [16])


def unbounded_index_needs_clamp(m):
    x = m.Var("x")
    img = m.ImageParam(m.Int(32), 1, "e_lut_src")
    lut = m.Func("e_lut")
    lut[x] = x * 2
    lut.compute_root()
    f = m.Func("e_gather")
    f[x] = lut[img[x]]
    img.set(np.zeros(4, np.int32))
    _realize(m, f, [4])


def select_condition_must_be_bool(m):
    m.select(m.i32(1), 2, 3)


def fold_storage_factor_too_small(m):
    x, y = m.Var("x"), m.Var("y")
    xo, yo, xi, yi = m.Var("xo"), m.Var("yo"), m.Var("xi"), m.Var("yi")
    inp = m.Buffer(np.zeros((32, 64), np.float32))
    bx, by = m.Func("fs_bx"), m.Func("fs_by")
    bx[x, y] = inp[x, y] * 2.0
    by[x, y] = bx[x, y] + bx[x, m.clamp(y + 1, 0, 31)]
    by.tile(x, y, xo, yo, xi, yi, 64, 8)
    bx.compute_at(by, xo)
    bx.fold_storage(y, 4)      # the tile needs 9 live rows of bx
    _realize(m, by, [64, 31])


def unclamped_data_dependent_index(m):
    x, y = m.Var("x"), m.Var("y")
    tab = m.Func("ub_tab")
    tab[x, y] = m.f32(x) * 0.25 + m.f32(y)
    tab.compute_root()
    inp = m.ImageParam(m.Float(32), 2, "ub_in")
    inp.set(np.full((4, 8), 2.5, np.float32))
    iv = m.i32(inp[x, y])
    out = m.Func("ub_out")
    out[x, y] = tab[iv, y] + tab[iv + 1, y]
    _realize(m, m.Pipeline(out), [8, 4])


# case -> what the message must hold (None: any CompileError)
ERRORS = {out_of_bounds_input: None, undefined_func: None,
          inline_func_with_updates: None, pure_def_requires_vars: None,
          duplicate_pure_vars: None, two_rdoms_in_definition: None,
          adorned_pure_var_in_update: None, update_arity_mismatch: None,
          wrong_call_arity: None, realize_undefined: None,
          unbound_imageparam: None, unset_param: None,
          bound_too_small: None, unbounded_index_needs_clamp: None,
          select_condition_must_be_bool: None,
          fold_storage_factor_too_small: "fold_storage",
          unclamped_data_dependent_index: "clamp"}


@pytest.mark.parametrize("case", list(ERRORS), ids=lambda c: c.__name__)
def test_errors_raise_in_both_packages(case):
    for m in (hl, ht):
        with pytest.raises(m.CompileError, match=ERRORS[case]):
            case(m)
