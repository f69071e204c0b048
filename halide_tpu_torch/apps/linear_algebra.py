"""linear_algebra: BLAS-style generators on the Func DSL
(reference: apps/linear_algebra/src/blas_l*_generators.cpp — saxpy/sdot/
sgemv/sgemm; apps/cuda_mat_mul). Contraction updates lower to one einsum
(eval_torch.try_einsum_reduce) past its grid threshold."""
from __future__ import annotations

import numpy as np

import halide_tpu_torch as hl

from . import App, register


def _build_gemm(name: str, dtype, np_dtype, M: int, N: int, K: int,
                alpha: float, beta: float,
                transpose_A: bool = False, transpose_B: bool = False,
                tolerance: float = 1e-2, atol: float = 1e-2) -> App:
    """General GEMM: C = alpha * op(A) @ op(B) + beta * C with
    the reference's transpose options (apps/linear_algebra/src/
    blas_l3_generators.cpp GEMMGenerator<T> transpose_A/transpose_B) and
    f32/f64 element types."""
    i, j = hl.Var("i"), hl.Var("j")
    A = hl.ImageParam(dtype, 2, "A")
    B = hl.ImageParam(dtype, 2, "B")
    C = hl.ImageParam(dtype, 2, "C")

    r = hl.RDom(0, K, "rk")
    prod = hl.Func(f"{name}_AB")
    prod[i, j] = hl.cast(dtype, 0.0)
    a_read = A[r.x, i] if transpose_A else A[i, r.x]
    b_read = B[j, r.x] if transpose_B else B[r.x, j]
    prod[i, j] += a_read * b_read
    out = hl.Func(name)
    out[i, j] = (hl.cast(dtype, alpha) * prod[i, j]
                 + hl.cast(dtype, beta) * C[i, j])

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        # Func dims map reversed onto np axes: A(i, k) -> np [k, i]
        a_shape = (M, K) if transpose_A else (K, M)
        b_shape = (K, N) if transpose_B else (N, K)
        return {"A": rng.standard_normal(a_shape).astype(np_dtype),
                "B": rng.standard_normal(b_shape).astype(np_dtype),
                "C": rng.standard_normal((N, M)).astype(np_dtype)}

    def reference(A, B, C):
        f = np_dtype
        a_spec = "ik" if transpose_A else "ki"   # np [k,i] unless T
        b_spec = "kj" if transpose_B else "jk"
        return (f(alpha) * np.einsum(f"{a_spec},{b_spec}->ji", A, B,
                                     dtype=f)
                + f(beta) * C).astype(f)

    return App(name, hl.Pipeline(out), [A, B, C], make_inputs, reference,
               [M, N], megapixels=M * N / 1e6, tolerance=tolerance,
               atol=atol, flops=2.0 * M * N * K + 3.0 * M * N)


@register("sgemm")
def build_sgemm(M: int = 2048, N: int = 2048, K: int = 2048,
                alpha: float = 1.5, beta: float = 0.5,
                transpose_A: bool = False, transpose_B: bool = False,
                **_ignored) -> App:
    return _build_gemm("sgemm", hl.Float(32), np.float32, M, N, K,
                       alpha, beta, transpose_A, transpose_B)


@register("sgemm_tn")
def build_sgemm_tn(M: int = 512, N: int = 512, K: int = 512,
                   **_ignored) -> App:
    """Transposed-A variant (reference GEMMGenerator transpose_ options)."""
    app = _build_gemm("sgemm_tn", hl.Float(32), np.float32, M, N, K,
                      1.5, 0.5, transpose_A=True)
    return app


@register("sgemm_nt")
def build_sgemm_nt(M: int = 512, N: int = 512, K: int = 512,
                   **_ignored) -> App:
    app = _build_gemm("sgemm_nt", hl.Float(32), np.float32, M, N, K,
                      1.5, 0.5, transpose_B=True)
    return app


@register("dgemm")
def build_dgemm(M: int = 512, N: int = 512, K: int = 512,
                alpha: float = 1.5, beta: float = 0.5,
                **_ignored) -> App:
    """Double precision."""
    return _build_gemm("dgemm", hl.Float(64), np.float64, M, N, K,
                       alpha, beta, tolerance=1e-9, atol=1e-9)


@register("hgemm")
def build_hgemm(M: int = 2048, N: int = 2048, K: int = 2048,
                alpha: float = 1.5, beta: float = 0.5, **_ignored) -> App:
    """bf16 GEMM: bf16 operands, f32 accumulate, f32 epilogue (reference
    baseline: apps/cuda_mat_mul/mat_mul_generator.cpp:24-25)."""
    i, j = hl.Var("i"), hl.Var("j")
    A = hl.ImageParam(hl.Float(32), 2, "A")
    B = hl.ImageParam(hl.Float(32), 2, "B")
    C = hl.ImageParam(hl.Float(32), 2, "C")

    r = hl.RDom(0, K, "rk")
    prod = hl.Func("ABh")
    bf = hl.BFloat(16)
    prod[i, j] = hl.cast(bf, 0.0)
    # the einsum lowering upcasts the bf16 factors to f32 (their products
    # are exact there) and accumulates in f32; only the final store rounds
    # to bf16
    prod[i, j] += hl.cast(bf, A[i, r.x]) * hl.cast(bf, B[r.x, j])
    out = hl.Func("hgemm")
    out[i, j] = alpha * hl.f32(prod[i, j]) + beta * C[i, j]

    def _to_bf16(x):
        # round-to-nearest-even truncation of the f32 mantissa, so the
        # device-side bf16 casts are exact
        u = x.view(np.uint32)
        r_ = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
        return r_.astype(np.uint32).view(np.float32)

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        return {
            "A": _to_bf16(rng.standard_normal((K, M)).astype(np.float32)),
            "B": _to_bf16(rng.standard_normal((N, K)).astype(np.float32)),
            "C": rng.standard_normal((N, M)).astype(np.float32)}

    def reference(A, B, C):
        f = np.float32
        acc = np.einsum("ki,jk->ji", A, B, dtype=f).astype(f)
        return (f(alpha) * _to_bf16(acc) + f(beta) * C).astype(f)

    return App("hgemm", hl.Pipeline(out), [A, B, C], make_inputs,
               reference, [M, N], megapixels=M * N / 1e6,
               tolerance=2e-2, atol=0.5,
               flops=2.0 * M * N * K + 3.0 * M * N)


@register("sgemv")
def build_sgemv(M: int = 4096, N: int = 4096, **_ignored) -> App:
    i = hl.Var("i")
    A = hl.ImageParam(hl.Float(32), 2, "A")   # (i, j)
    xv = hl.ImageParam(hl.Float(32), 1, "x")
    r = hl.RDom(0, N, "rj")
    out = hl.Func("sgemv")
    out[i] = 0.0
    out[i] += A[i, r.x] * xv[r.x]

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        return {"A": rng.standard_normal((N, M)).astype(np.float32),
                "x": rng.standard_normal(N).astype(np.float32)}

    def reference(A, x):
        return np.einsum("ji,j->i", A, x,
                         dtype=np.float32).astype(np.float32)

    return App("sgemv", hl.Pipeline(out), [A, xv], make_inputs, reference,
               [M], megapixels=M / 1e6, tolerance=1e-2, atol=1e-2)


@register("saxpy")
def build_saxpy(N: int = 1 << 22, a: float = 1.5, **_ignored) -> App:
    i = hl.Var("i")
    xv = hl.ImageParam(hl.Float(32), 1, "x")
    yv = hl.ImageParam(hl.Float(32), 1, "y")
    out = hl.Func("saxpy")
    out[i] = a * xv[i] + yv[i]

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        return {"x": rng.standard_normal(N).astype(np.float32),
                "y": rng.standard_normal(N).astype(np.float32)}

    def reference(x, y):
        return (np.float32(a) * x + y).astype(np.float32)

    return App("saxpy", hl.Pipeline(out), [xv, yv], make_inputs, reference,
               [N], megapixels=N / 1e6, tolerance=1e-6, atol=1e-6)


@register("sdot")
def build_sdot(N: int = 1 << 22, **_ignored) -> App:
    i = hl.Var("i")
    xv = hl.ImageParam(hl.Float(32), 1, "x")
    yv = hl.ImageParam(hl.Float(32), 1, "y")
    r = hl.RDom(0, N, "rd")
    out = hl.Func("sdot")
    out[i] = 0.0
    out[i] += xv[r.x] * yv[r.x]

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        return {"x": (rng.standard_normal(N) * 0.01).astype(np.float32),
                "y": (rng.standard_normal(N) * 0.01).astype(np.float32)}

    def reference(x, y):
        return np.array([np.dot(x.astype(np.float64),
                                y.astype(np.float64))], np.float32)

    return App("sdot", hl.Pipeline(out), [xv, yv], make_inputs, reference,
               [1], megapixels=N / 1e6, tolerance=1e-2, atol=1e-1)


@register("sscal_scopy")
def build_sscal_scopy(N: int = 1 << 22, a: float = 2.5, **_ignored) -> App:
    """L1 scal + copy in one two-output pipeline (reference:
    apps/linear_algebra/src/blas_l1_generators.cpp ScalGenerator/
    CopyGenerator)."""
    i = hl.Var("i")
    xv = hl.ImageParam(hl.Float(32), 1, "x")
    scal = hl.Func("sscal")
    scal[i] = a * xv[i]
    copy = hl.Func("scopy")
    copy[i] = xv[i]

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        return {"x": rng.standard_normal(N).astype(np.float32)}

    def reference(x):
        return [np.float32(a) * x, x.copy()]

    return App("sscal_scopy", hl.Pipeline([scal, copy]), [xv], make_inputs,
               reference, [N], megapixels=N / 1e6)


@register("sasum")
def build_sasum(N: int = 1 << 22, **_ignored) -> App:
    """L1 asum: sum of |x| (reference: blas_l1_generators.cpp
    AsumGenerator; rfactor'd into lane partials like the reference's
    vectorized reduction)."""
    i = hl.Var("i")
    xv = hl.ImageParam(hl.Float(32), 1, "x")
    r = hl.RDom(0, N, "ra")
    out = hl.Func("sasum")
    out[i] = 0.0
    out[i] += hl.abs(xv[r.x])

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        return {"x": (rng.standard_normal(N) * 0.01).astype(np.float32)}

    def reference(x):
        return np.array([np.abs(x.astype(np.float64)).sum()], np.float32)

    return App("sasum", hl.Pipeline(out), [xv], make_inputs, reference,
               [1], megapixels=N / 1e6, tolerance=1e-2, atol=1e-1)


@register("sger")
def build_sger(M: int = 4096, N: int = 4096, a: float = 1.5,
               **_ignored) -> App:
    """L2 ger: rank-1 update A += a*x*y^T (reference:
    apps/linear_algebra/src/blas_l2_generators.cpp GerGenerator)."""
    i, j = hl.Var("i"), hl.Var("j")
    A = hl.ImageParam(hl.Float(32), 2, "A")
    xv = hl.ImageParam(hl.Float(32), 1, "x")
    yv = hl.ImageParam(hl.Float(32), 1, "y")
    out = hl.Func("sger")
    out[i, j] = A[i, j] + a * xv[i] * yv[j]

    def make_inputs(seed=0):
        rng = np.random.default_rng(seed)
        return {"A": rng.standard_normal((N, M)).astype(np.float32),
                "x": rng.standard_normal(M).astype(np.float32),
                "y": rng.standard_normal(N).astype(np.float32)}

    def reference(A, x, y):
        return (A + np.float32(a) * y[:, None] * x[None, :]).astype(
            np.float32)

    return App("sger", hl.Pipeline(out), [A, xv, yv], make_inputs,
               reference, [M, N], megapixels=M * N / 1e6, tolerance=1e-4,
               atol=1e-4)
