"""Chip check of the PyTorch/CUDA port (halide_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's fixed kernel sources (the scan kernel K2 and the row-
histogram kernel K3) with nvcc, in parallel, then drives the port's main
paths through `App.bind` / `Pipeline.realize` on the card:

- blur (the README quick-start schedule, 2560x1536 u16) and linear_blur
  (1536x2560x3 f32) through the stencil-group kernel K1;
- interpolate (1536x2560x4 f32, 10 levels) and local_laplacian
  (1536x2560x3 u16, 8 pyramid levels, 8 intensity levels) through K1 with
  div-indexed windows (the half-resolution level read at x / 2), tile
  256x64;
- iir_blur (1536x2560x3 f32): four constant-coefficient scans, K2a;
- hist (1536x2560x3 u8): one row histogram, K3;
- a where-predicated scan (1536x2560 f32): one per-element scan, K2b.

Each kernel's launch count is set to 0 just before its path's realize and
must have the expected value just after (for K1, with no rejected plan).
Each kernel is called again on the arguments the main path gave it and held
against its plain PyTorch version, and each output against its golden. Then
it times, with CUDA events, each kernel (its device time), its plain version,
the whole realize (what a caller waits for) and, where one PyTorch call
computes the same function, that call; and breaks one realize of each app
down by device time with the profiler.

Every phase prints one flushed line with its elapsed seconds. A watchdog
ends the script with exit code 1 after 600 s, naming the phase it was in.
It exits 1 without a result where torch sees no CUDA device, and fails
where the package is not beside it. The last line of its output is
{"ok": true, "device": {...}}; the line before it is the kernel table, and
the line before that the card's name and power limit.
"""
import json
import math
import signal
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

T0 = time.time()
PHASE = ["start"]
DEADLINE_S = 600
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM outside the tensor cores


class Deadline(Exception):
    pass


def _alarm(_sig, _frame):
    raise Deadline()


def say(msg):
    print(f"[{time.time() - T0:7.1f}s] {PHASE[0]}: {msg}", flush=True)


def phase(name):
    PHASE[0] = name
    say("begin")


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def event_ms(fn, iters, flush=None, hold=False):
    """Median CUDA-event time of fn() after a warm-up call; `flush` runs
    between calls, outside the timed region (a frame's input is not in L2
    when a caller realizes it). With `hold`, the card first spins while the
    host enqueues every call, so each pair of events brackets the kernels
    alone (the device time, without the host's launch overhead); without
    it, the card is idle when each start event is recorded (the flush has
    finished), and the events also see the host work between them, as a
    caller does."""
    fn()
    torch.cuda.synchronize()
    if hold:
        torch.cuda._sleep(100_000_000)     # ~0.05 s of GPU cycles
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush()
        if not hold:
            torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
        if not hold:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def count_ops(plan):
    """Operations the group's point expressions do: the output's at each of
    its points, each member's at each output (x, y) point times its static
    dims (local_laplacian's 8 planes), without the halo the kernel
    recomputes."""
    from halide_tpu_torch import expr as E
    from halide_tpu_torch.visitors import walk

    def ops(v):
        n = [0]

        def fn(e):
            if isinstance(e, (E.Binary, E.Select, E.Intrin, E.Not)):
                n[0] += 1
        walk(v, fn)
        return n[0]
    per_xy = plan.extents[plan.xi] * (
        plan.extents[plan.yi] if plan.yi is not None else 1)
    total = ops(plan.value) * int(np.prod(plan.extents))
    for m in plan.members:
        total += ops(m.value) * per_xy * int(np.prod(
            [e for k, _d, _o, e in m.dims if k == "s"]))
    return total


def window_bytes(plan, inputs, rmins):
    """Bytes of the inputs a group must read: each window's footprint over
    all sub-tiles (the union of its staged boxes), within the realized
    region, read once."""
    from halide_tpu_torch.ops import group_kernel as gk
    origins = list(gk._origins(plan))
    total = 0
    for w, arr, rmin in zip(plan.windows, inputs, rmins):
        boxes = [gk._stage_box(w, x0, y0) for x0, y0 in origins]
        n = 1
        for j in range(len(w.dims)):
            size = arr.shape[arr.ndim - 1 - j]
            lo = max(min(b[j][0] for b in boxes), rmin[j])
            hi = min(max(b[j][0] + b[j][1] - 1 for b in boxes),
                     rmin[j] + size - 1)
            n *= max(hi - lo + 1, 0)
        total += n * arr.element_size()
    return total


PORT_KERNELS = ("group_", "scan_lines", "rowhist_blocks")


def breakdown(app):
    """Where one realize's time goes: host wall time, the device's busy
    time from the profiler's kernel events, split between the port's
    kernels and the torch ops around them, and the kernels by device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    app.realize()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        app.realize()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy = sum(us for us, _n in by_name.values())
    ours = sum(us for name, (us, _n) in by_name.items()
               if any(k in name for k in PORT_KERNELS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    say(f"{app.name} realize: wall {wall_us:.1f} us, device busy "
        f"{busy:.1f} us (idle share {1 - busy / wall_us:.3f}): the port's "
        f"kernels {ours:.1f} us, torch ops {busy - ours:.1f} us; by device "
        "time: " + "; ".join(f"{name[:70]} {us:.1f} us x{n}"
                             for name, (us, n) in top))


def capture(mod, fname, fn):
    """Run fn() with mod.fname wrapped so that every call's arguments are
    kept (tensors cloned, so that later writes leave them as they were);
    -> (fn's result, [(args, kwargs)])."""
    calls = []
    orig = getattr(mod, fname)

    def keep(v):
        return v.clone() if isinstance(v, torch.Tensor) else v

    def spy(*args, **kw):
        calls.append(([keep(a) for a in args],
                      {k: keep(v) for k, v in kw.items()}))
        return orig(*args, **kw)

    setattr(mod, fname, spy)
    try:
        return fn(), calls
    finally:
        setattr(mod, fname, orig)


def check_golden(name, got, ref, rtol, atol, frac=0.0):
    """The output against its golden (the rule of tests/test_apps.py):
    finite, and |got - ref| <= atol + rtol |ref| on all but a share `frac`
    of the points (an app's mismatch share; 0 elsewhere, so that zero
    tolerances mean bit for bit)."""
    if got.shape != ref.shape:
        raise SystemExit(f"{name}: shape {got.shape} != {ref.shape}")
    gf, rf = got.astype(np.float64), np.asarray(ref, np.float64)
    gerr = float(np.abs(gf - rf).max())
    bad = float((np.abs(gf - rf) > atol + rtol * np.abs(rf)).mean())
    ok = bool(np.isfinite(got).all()) and bad <= frac
    say(f"output vs golden: max abs err {gerr!r}, share beyond atol {atol} "
        f"+ rtol {rtol} {bad!r} (allowed {frac}), ok {ok}")
    if not ok:
        raise SystemExit(f"{name}: output disagrees with the golden")


def scan_vs_plain(calls, tol):
    """K2 on the main path's arguments against its plain version."""
    from halide_tpu_torch.ops import scan_kernel as sk
    err = 0.0
    for (out, b, init, axis, backward), kw in calls:
        k = sk.launch(torch.empty_like(out), b, init, axis, backward, **kw)
        p = sk.linear_scan_plain(b, init, axis, backward, **kw)
        torch.cuda.synchronize()
        err = max(err, (k - p).abs().max().item())
    say(f"scan kernel vs plain version over {len(calls)} calls: max abs "
        f"err {err!r} (tolerance {tol})")
    if not err <= tol:
        raise SystemExit(f"scan kernel disagrees with its plain version: "
                         f"{err} > {tol}")
    return err


def predicated_scan(width, height, seed=0):
    """The where-predicated recurrence of tests/test_reductions.py
    (test_masked_linear_scan): g[x, r] = 0.5 g[x, r-1] + inp[x, r] where r
    is even. -> (pipeline, its input, the float64 golden)."""
    import halide_tpu_torch as hl
    x, y = hl.Var("x"), hl.Var("y")
    inp = hl.ImageParam(hl.Float(32), 2, "pin")
    a = np.random.default_rng(seed).random((height, width), np.float32)
    inp.set(torch.from_numpy(a).cuda())
    r = hl.RDom(1, height - 1)
    r.where(r.x % 2 == 0)
    g = hl.Func("masked_scan")
    g[x, y] = 0.0
    g[x, 0] = inp[x, 0]
    g[x, r.x] = 0.5 * g[x, r.x - 1] + inp[x, r.x]
    w = np.zeros((height, width), np.float64)
    w[0] = a[0]
    for i in range(1, height):
        w[i] = (0.5 * w[i - 1] + a[i]) if i % 2 == 0 else w[i]
    return hl.Pipeline(g), w


def run_app(app, tile_note, tol, rtol=0.0, frac=0.0, cap=math.inf):
    """One app on the main path: bind, realize on the card with the counts
    at 0 (exactly one K1 launch and no rejected plan), then hold the kernel
    against its plain version (|k - p| <= tol + rtol |p| on all but a share
    `frac` of the points, and |k - p| <= `cap` on every point) and the
    output against the golden (the app's own rule). -> the group's call,
    its launches, the kernel's max abs error against its plain version and
    the plain version's ms (one call)."""
    from halide_tpu_torch.ops import group_kernel as gk
    data = app.make_inputs(0)
    app.bind(data)                         # onto the card
    built = len(gk.builds)
    gk.launches = 0
    gk.rejects.clear()
    out = app.realize()                    # the main path
    torch.cuda.synchronize()
    launches, rejects = gk.launches, dict(gk.rejects)
    say(f"{tile_note}: realize ok, kernel launches {launches}, "
        f"rejects {rejects}, plan {gk.last_plan}")
    if launches != 1 or rejects:
        raise SystemExit(f"{app.name}: the main path did not go through "
                         f"the group kernel once (launches {launches}, "
                         f"rejects {rejects})")
    for h, secs in gk.builds[built:]:
        say(f"nvcc build {h}: {secs:.1f} s")
    plan, inputs, rmins, params, _realz = gk.group_call(app.pipeline)
    kern = gk.launch(plan, inputs, rmins)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = gk.run_plain(plan, inputs, rmins, params, inputs[0].device)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    diff = (kern.double() - plain.double()).abs()
    err = diff.max().item()
    bad = (diff > tol + rtol * plain.double().abs()).double().mean().item()
    say(f"kernel vs plain version ({plain_ms / 1e3:.1f} s): max abs err "
        f"{err!r} (allowed {cap}), share beyond {tol} + {rtol} |p| {bad!r} "
        f"(allowed {frac})")
    if not (bad <= frac and err <= cap):
        raise SystemExit(f"{app.name}: kernel disagrees with its plain "
                         f"version: {bad} of the points beyond {tol} + "
                         f"{rtol} |p|, max abs err {err}")
    check_golden(app.name, out.to_numpy(), app.reference(**data),
                 app.tolerance, app.atol, app.mismatch_frac)
    return plan, inputs, rmins, params, launches, err, plain_ms


def kernel_row(name, source, replaces, launches, err, k_ms, p_ms, nbytes,
               ops, lib_ms, **extra):
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = ops / F32_OPS_PER_S * 1e3
    return dict({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": max(b_bytes, b_ops),
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "library_ms": lib_ms}, **extra)


def main():
    signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(DEADLINE_S)

    phase("device")
    if not torch.cuda.is_available():
        say("torch sees no CUDA device")
        sys.exit(1)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    say(f"{name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    import halide_tpu_torch  # noqa: F401  (fails where the port is absent)
    from halide_tpu_torch.apps import (blur, hist, iir_blur, interpolate,
                                       linear_blur, local_laplacian)
    from halide_tpu_torch.ops import build
    from halide_tpu_torch.ops import group_kernel as gk
    from halide_tpu_torch.ops import rowhist_kernel as rk
    from halide_tpu_torch.ops import scan_kernel as sk

    phase("build")
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(build.load_fixed, n)
                  for n in ("scan_kernel", "rowhist_kernel")]:
            f.result()
    for key, secs in build.builds:
        say(f"nvcc build {key}: {secs:.1f} s")

    phase("blur")
    app_b = blur.build(2560, 1536, tile=(256, 128))
    res_b = run_app(app_b, "blur 2560x1536 u16, tile 256x128", 0)

    phase("linear_blur")
    app_l = linear_blur.build(1536, 2560)
    res_l = run_app(app_l, "linear_blur 1536x2560x3 f32, tile 1536x256",
                    1e-4)

    phase("interpolate")
    app_p = interpolate.build(1536, 2560)
    res_p = run_app(app_p, "interpolate 1536x2560x4 f32, 10 levels, tile "
                    "256x64", 0.0, rtol=1e-5)

    phase("local_laplacian")
    app_ll = local_laplacian.build(1536, 2560)
    res_ll = run_app(app_ll, "local_laplacian 1536x2560x3 u16, 8+8 levels, "
                     "tile 256x64", 0.0, frac=0.003, cap=2.0)

    phase("iir_blur")
    app_i = iir_blur.build(1536, 2560, 0.1)
    data_i = app_i.make_inputs(0)
    app_i.bind(data_i)
    sk.launches["const"] = sk.launches["general"] = 0
    out_i, calls_i = capture(sk, "linear_scan", app_i.realize)
    torch.cuda.synchronize()
    n_i = dict(sk.launches)
    say(f"1536x2560x3 f32, alpha 0.1: realize ok, scan kernel launches "
        f"{n_i}")
    if n_i != {"const": 4, "general": 0}:
        raise SystemExit(f"iir_blur: the main path did not go through K2a "
                         f"four times ({n_i})")
    err_i = scan_vs_plain(calls_i, 1e-5)
    check_golden("iir_blur", out_i.to_numpy(), app_i.reference(**data_i),
                 app_i.tolerance, app_i.atol)

    phase("hist")
    app_h = hist.build(1536, 2560)
    data_h = app_h.make_inputs(0)
    app_h.bind(data_h)
    rk.launches = 0
    out_h, calls_h = capture(rk, "rowhist", app_h.realize)
    torch.cuda.synchronize()
    n_h = rk.launches
    say(f"1536x2560x3 u8: realize ok, row-histogram kernel launches {n_h}")
    if n_h != 1 or len(calls_h) != 1:
        raise SystemExit(f"hist: the main path did not go through K3 once "
                         f"({n_h} launches)")
    (lin_h, K_h, scale_h), _kw = calls_h[0]
    k = rk.launch(lin_h, K_h, scale_h)
    p = rk.rowhist_plain(lin_h, K_h, scale_h)
    torch.cuda.synchronize()
    err_h = (k - p).abs().max().item()
    say(f"K3 vs plain version on lin {tuple(lin_h.shape)} stride "
        f"{lin_h.stride()}, K {K_h}: max abs err {err_h!r} (exact)")
    if not torch.equal(k, p):
        raise SystemExit("hist: K3 disagrees with its plain version")
    check_golden("hist", out_h.to_numpy(), app_h.reference(**data_h),
                 app_h.tolerance, app_h.atol)

    phase("scan_general")
    pipe_g, golden_g = predicated_scan(1536, 2560)
    sk.launches["const"] = sk.launches["general"] = 0
    out_g, calls_g = capture(sk, "linear_scan",
                             lambda: pipe_g.realize([1536, 2560]))
    torch.cuda.synchronize()
    n_g = dict(sk.launches)
    say(f"where-predicated scan 1536x2560 f32: realize ok, scan kernel "
        f"launches {n_g}")
    if n_g != {"const": 0, "general": 1}:
        raise SystemExit(f"scan_general: the main path did not go through "
                         f"K2b once ({n_g})")
    err_g = scan_vs_plain(calls_g, 1e-5)
    # the same call with coefficients that carry the recurrence far
    (out0, b0, init0, axis0, bwd0), _kw0 = calls_g[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    a_r = torch.rand(b0.shape, device="cuda", generator=gen) * 1.9 - 0.95
    err_g = max(err_g, scan_vs_plain(
        [((out0, b0, init0, axis0, bwd0), {"a": a_r})], 1e-5))
    check_golden("scan_general", out_g.to_numpy(), golden_g, 0, 1e-4)

    phase("times")
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()

    kernels = []
    for app, (plan, inputs, rmins, params, launches, err, p_ms) in (
            (app_b, res_b), (app_l, res_l), (app_p, res_p),
            (app_ll, res_ll)):
        k_ms = event_ms(lambda: gk.launch(plan, inputs, rmins), 30, flush,
                        hold=True)
        r_ms = event_ms(app.realize, 20, flush)
        nbytes = window_bytes(plan, inputs, rmins) \
            + int(np.prod(plan.extents)) * gk.itemsize(plan.out_type)
        ops = count_ops(plan)
        row = kernel_row(
            f"K1 stencil group ({app.name})",
            "halide_tpu_torch/ops/group_kernel.py",
            "halide_tpu/ops/pallas_group.py:696", launches, err, k_ms, p_ms,
            nbytes, ops, None, realize_ms=r_ms, sub_tile=[plan.sx, plan.sy],
            smem_bytes=plan.smem,
            library_note="no single PyTorch call computes a fused group")
        kernels.append(row)
        say(f"{app.name} on {card}: kernel {k_ms:.4f} ms (device), plain "
            f"version {p_ms:.1f} ms (one call), whole realize {r_ms:.4f} ms "
            f"(host, to completion); bound {row['bound_ms'] * 1e3:.2f} us "
            f"({nbytes} bytes, {ops} operations)")

    def scan_times(calls):
        """Summed over the calls: kernel and plain-version ms, bytes, ops."""
        k_ms = p_ms = 0.0
        nbytes = ops = 0
        for (out, b, init, axis, bwd), kw in calls:
            o = torch.empty_like(out)
            t_k = event_ms(lambda: sk.launch(o, b, init, axis, bwd, **kw),
                           30, flush, hold=True)
            t_p = event_ms(lambda: sk.linear_scan_plain(b, init, axis, bwd,
                                                        **kw), 3)
            n = out.numel()
            nb = 4 * (2 * n + init.numel() + (n if "a" in kw else 0))
            say(f"  scan {tuple(out.shape)} axis {axis} backward {bwd}: "
                f"kernel {t_k:.4f} ms, plain {t_p:.2f} ms, bound "
                f"{nb / HBM_BYTES_PER_S * 1e6:.2f} us ({nb} bytes)")
            k_ms, p_ms, nbytes, ops = k_ms + t_k, p_ms + t_p, nbytes + nb, \
                ops + 2 * n
        return k_ms, p_ms, nbytes, ops

    k_ms, p_ms, nbytes, ops = scan_times(calls_i)
    r_ms = event_ms(app_i.realize, 20, flush)
    kernels.append(kernel_row(
        "K2a scan, constant coefficient (iir_blur, per realize)",
        "halide_tpu_torch/ops/csrc/scan_kernel.cu",
        "halide_tpu/ops/pallas_scan.py:39", n_i["const"], err_i, k_ms, p_ms,
        nbytes, ops, None, realize_ms=r_ms,
        library_note="no single torch call computes a recurrence with "
                     "a != 1 (cumsum is a = 1)"))
    say(f"iir_blur on {card}: K2a x4 {k_ms:.4f} ms (device), plain "
        f"{p_ms:.2f} ms, whole realize {r_ms:.4f} ms; bound "
        f"{nbytes / HBM_BYTES_PER_S * 1e6:.2f} us")

    k_ms, p_ms, nbytes, ops = scan_times(calls_g[:1])
    r_ms = event_ms(lambda: pipe_g.realize([1536, 2560]), 20, flush)
    kernels.append(kernel_row(
        "K2b scan, per-element coefficient (predicated scan)",
        "halide_tpu_torch/ops/csrc/scan_kernel.cu",
        "halide_tpu/ops/pallas_scan.py:71", n_g["general"], err_g, k_ms,
        p_ms, nbytes, ops, None, realize_ms=r_ms,
        library_note="no single torch call computes a recurrence with "
                     "a != 1 (cumsum is a = 1)"))
    say(f"scan_general on {card}: K2b {k_ms:.4f} ms (device), plain "
        f"{p_ms:.2f} ms, whole realize {r_ms:.4f} ms")

    R, P = lin_h.shape
    k_ms = event_ms(lambda: rk.launch(lin_h, K_h, scale_h), 30, flush,
                    hold=True)
    p_ms = event_ms(lambda: rk.rowhist_plain(lin_h, K_h, scale_h), 3)
    rows = torch.arange(R, device="cuda", dtype=torch.int64)[:, None]
    lin64 = lin_h.to(torch.int64)
    keys = (rows * (K_h + 1) + torch.where(
        (lin64 < 0) | (lin64 >= K_h), K_h, lin64)).reshape(-1)
    want = torch.bincount(keys, minlength=R * (K_h + 1)).reshape(
        R, K_h + 1)[:, :K_h].float() * scale_h
    if not torch.equal(want, k):
        raise SystemExit("hist: bincount disagrees with K3")
    # bincount reads its input's maximum back to the host: timed to
    # completion from an idle card, as a caller waits for it
    lib_ms = event_ms(lambda: torch.bincount(keys, minlength=R * (K_h + 1)),
                      30, flush)
    r_ms = event_ms(app_h.realize, 20, flush)
    nbytes = lin_h.numel() * 4 + R * K_h * 4
    kernels.append(kernel_row(
        "K3 row histogram (hist)", "halide_tpu_torch/ops/csrc/"
        "rowhist_kernel.cu", "halide_tpu/ops/onehot_mxu.py:103", n_h, err_h,
        k_ms, p_ms, nbytes, 2 * lin_h.numel(), lib_ms, realize_ms=r_ms))
    say(f"hist on {card}: K3 {k_ms:.4f} ms (device), plain {p_ms:.2f} ms, "
        f"bincount {lib_ms:.4f} ms (to completion), whole realize "
        f"{r_ms:.4f} ms; bound {nbytes / HBM_BYTES_PER_S * 1e6:.2f} us "
        f"({nbytes} bytes)")

    phase("breakdown")
    for app in (app_b, app_l, app_p, app_ll, app_i, app_h):
        breakdown(app)

    phase("kernels")
    signal.alarm(0)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except Deadline:
        print(f"chip_smoke: watchdog: {DEADLINE_S} s passed in phase "
              f"{PHASE[0]!r}", flush=True)
        sys.exit(1)
    finally:
        signal.alarm(0)
