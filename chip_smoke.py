"""Chip check of the PyTorch/CUDA port (halide_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

First it plans every stencil group of the apps below (one realize each, with
the group kernel's launch replaced by a stand-in that only keeps the plan),
and builds every kernel source with nvcc, all started together: each
group's emitted source, the scan kernel K2 and the row-histogram kernel K3.
Then it drives the port's main paths through `App.bind` /
`Pipeline.realize` on the card:

- blur (the README quick-start schedule, 2560x1536 u16) and linear_blur
  (1536x2560x3 f32) through the stencil-group kernel K1; linear_blur's
  full-width row bands make its launch a band walk, its store_root
  members computed whole in every sub-tile as any member;
- interpolate (1536x2560x4 f32, 10 levels) and local_laplacian
  (1536x2560x3 u16, 8 pyramid levels, 8 intensity levels) through K1 with
  div-indexed windows (the half-resolution level read at x / 2), tile
  256x64;
- stencil_chain (1536x2560 u16, 32 stencils, the kernel branch): four K1
  launches, one per group of 8 stencils; the last is a band walk, the
  others are wider than their tile (1632, 1600, 1568 at the tile 1536);
  and its slide=512 branch on the same input: four K1 launches of 15
  members each, stored at the tiles' row loop;
- a group whose member is a hand-built Let (`let_group`), in float16 and
  bfloat16 at 1536x2560, tile 256x128: K1's 16-bit floats, exact against
  its plain version and the untiled pipeline;
- camera_pipe (2560x1920 u8 out, the kernel branch) at the full-width tile
  2560x128 (a band walk) and at the tile 256x64;
- a 1536x2560 f32 tile reading a producer at (x / 8, y / 8): K1's d = 8
  window, the counterpart of the JAX package's 8-fold repeat;
- iir_blur (1536x2560x3 f32): four constant-coefficient scans, K2a (also
  timed at both segment lengths the kernel takes);
- hist (1536x2560x3 u8): one row histogram, K3; then K3 alone at the plan
  its rule gives and at its first design's geometry in this build (8 rows,
  256 threads, 4-byte loads, 8 in flight), on hist's lin, the same values
  transposed (rows_fast), offset by one element (base not 16-byte
  aligned), cut to a width of 1535 (4-byte loads), one bin a row and a ramp
  at that shape, and 256 x 65,536 and 64 x 262,144 uniform bins (the last
  split over a cluster), each exactly equal to the plain version, then
  timed (hist's lin also through builds with counting, and with the loads
  too, compiled out);
- a where-predicated scan (1536x2560 f32): one per-element scan, K2b;
- unsharp and harris (1536x2560x3 f32 in) and wavelet (1536x2560 f32) at
  their default schedules, whole-array (no group kernel launch), each
  against its golden and timed beside the reference Halide's GPU column;
- unsharp and harris again with the output tiled 256x128 and the wide
  producers computed at the tiles (`apps.tile_producers`): one K1 launch
  each (harris's 1530x2554 output takes shifted-inwards last tiles, and
  its compute_with pair sits inside the group);
- a group of integer intrinsics (floor and round-to-zero division, bit
  counts, reinterpret, recip of the bits; `intrinsic_group`) at 1536x2560
  for i32, u16 and u32 lanes through K1, exactly equal to its plain version
  and to the untiled pipeline's whole-array values; a u64 pipeline
  (`u64_pipeline`) against numpy;
- last, the `reductions` phase: nl_means (1536x2560x3 f32, patch 7,
  search 7), whose three 4-D box sums (inline hl.sum stages) are one K1
  launch on 256x64 tiles, held against its plain version on the first and
  last band's sub-tile rows and its golden, timed beside its bound and the
  reference Halide's GPU time, and broken down by device time; then
  gaussian_blur (1536x2560), conv_layer and depthwise_separable_conv at
  their defaults, sgemm and hgemm at 2048^3, dgemm at 512^3, sasum at
  2^22, max_filter (1536x2560x3, radius 26) and fft (256x256), whole-array,
  each against its golden, with the lowering its updates and inline
  reductions took, its realize time (beside the reference Halide's GPU
  time where there is one) and the device times of its convolution and
  einsum calls timed alone; and an integer argmax over a 5x4 RDom with
  ties (`argmax_pipeline`) against numpy;
- then the `slice2_apps` phase: compositing (1536x2560, six u8 RGBA
  layers), whose tuple-valued `blended` and its masked 5x5 update chain
  are a member of one K1 launch on 256x128 tiles, and bilateral_grid
  (1536x2560 f32) and bgu (1536x2560x3 f32), whose trilinear slices are
  one K1 launch each on 512x256 tiles, each held against its plain
  version on the first and the last band (compositing exactly, the
  slices within rtol 1e-5) and its golden, timed beside its bound, the
  reference Halide's GPU time and its idle share; bilateral_grid's z
  planes against its staged window, and its and bgu's two realizes
  against each other (their float scatters add in any order); resize
  (scale 0.5) and lens_blur (192x320) whole-array against their goldens
  (lens_blur's stochastic default by its structure, its zero-radius case
  within 1e-4), with the lowering of their sums;
- then the `slice3_surface` phase, the surface around realize at the
  canonical sizes: unsharp under a `specialize` ladder on a Param (its
  tiled branch one K1 launch, its default none, each against its golden
  and timed in turns beside the same schedule put on without a ladder);
  camera_pipe (2560x1920 at 256x64), iir_blur and hist written by the
  serializer, read back and realized bit for bit with the same launches
  (K1, K2a, K3) and the same K1 plan geometry; blur (2560x1536, 256x128)
  under `trace_all`, then traced to a file (the events per Func, the
  stored payload equal to the output, the file's size); local_laplacian
  profiled in both modes (the fused total within 2x of the realize);
  camera_pipe with its tone curve computed at root and memoized (the
  second realize a hit in the native LRU, both bit for bit the inline
  curve's output; the miss, hit and key-hashing times); blur over an
  extern stage that makes its input on the host (through K1, against its
  golden, with the round trip's copy times); and a `debug_to_file` dump
  of blur's compute_root producer, equal to it;
- then the `slice3_tools` phase: blur (2560x1536 u16), unsharp and
  harris (1536x2560x3 f32) and camera_pipe (2560x1920) with their
  producers unscheduled (camera_pipe's demosaic roots kept) and estimates
  at those sizes, scheduled by Mullapudi2016 and by Adams2019
  (`auto_app`), each against its golden and its manual
  schedule's output (blur's and camera_pipe's tiles above, unsharp and
  harris tiled 256x128) with its K1 launches (one at least each), and
  manual and auto realizes timed in turns;
  Anderson2021 on blur (its candidates timed on the card); fitcost on the
  card beside the package's sm_90 row; tilesearch on blur with a menu of
  three tiles; `gen -e object` of blur (tiled 256x128) and hist,
  reloaded and run on the card: K1 / K3 launched once, bit for bit
  realize's output, timed beside it; `rungen iir_blur --benchmarks`
  (K2a); and `propagate_adjoints` of a tiled float stencil with a Param
  at 1536x2560 (`grad_stencil`: its forward one K1 launch, whose output
  is held against the plain version and realize's; the gradient, which
  the backward computes by the plain version's recomputation, against the
  port on the CPU within rtol 1e-5);
- then the `distribute` phase: blur's 3x3 box with its edges repeated
  (`sharded_blur`, 2560x1536 u16, tiled 256x128) with `distribute(y)`
  realized over a mesh of 4 shard slots of the card (parallel.Mesh):
  one K1 launch a shard, each held against its plain version, the whole
  bit for bit against the unsharded realize and numpy, both realizes
  timed in turns; the histogram of a 1536x2560 int32 image into 256 bins
  with `distribute(r.y)`, bit for bit against torch.bincount, with the
  route its shards' updates took; and `parallel.dryrun_multichip(4)`;
- the `resnet_50` phase: the canonical network (layers (3,4,6,3), width
  64, 1000 classes, 224x224, batch 4; random weights from a seed)
  against its numpy golden at the app's tolerance, its logits normwise
  within 1e-4 (LOGITS_RTOL), beside a TF32 control run of the same
  network that must exceed that limit, every conv2d on the convolution
  path and fc on the einsum path, the planning and the cached realize on the host clock,
  the realize by CUDA events with its TFLOP/s, the device time of its
  convolution and einsum calls timed alone, and its breakdown;
- the `stage_kernel` phase: local_laplacian (1536x2560x3), camera_pipe
  (2560x1920, tile 2560x128) and resnet_50 (batch 4) realized once more
  with their plans dropped, so that no CUDA graph replays them: the stage
  kernel's count equal to the stages it takes; then each stage's kernel
  on the arrays that realize gave it, against eval_torch's evaluation of
  the same stage on the same arrays, and timed beside its bytes bound;
- the `tutorials` phase: each lesson of tutorials_torch/ run with
  main("cuda"), with its seconds and the K1 launches of all 30.

Each kernel's launch count is set to 0 just before its path's realize and
must have the expected value just after (for K1, with no rejected plan, and
a grid of cdiv(extent, sx) x cdiv(extent_y, sy) sub-tiles: no output
computed twice).
Each kernel is called again on the arguments the main path gave it and held
against its plain PyTorch version (for stencil_chain and camera_pipe on the
output rows of the first two and the last two bands of each launch, where
the plain version's Python loop over every sub-tile would take minutes),
and each output against its golden. Then it times, with CUDA events, each
kernel (its device time; K1 on linear_blur also with the same build walking
two sub-tiles a block and with its band walk turned off), its plain
version, the whole realize (what a caller waits for) and, where one PyTorch
call computes the same function, that call; and breaks one realize of each
app down by device time with the profiler.

Every phase prints one flushed line with its elapsed seconds, and the
seconds it took when the next begins. A watchdog
ends the script with exit code 1 after 600 s, naming the phase it was in.
It exits 1 without a result where torch sees no CUDA device, and fails
where the package is not beside it. The last line of its output is
{"ok": true, "device": {...}}; the line before it is the kernel table, and
the line before that the card's name and power limit.
"""
import json
import math
import os
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
PHASE_T = [T0]
DEADLINE_S = 600
DIST_SHARDS = 4               # shard slots on the card in phase distribute
# resnet_50's logits, max |err| / max |logit| against the numpy golden: the
# f32 network reads ~7e-7 on an H100; a TF32 control run must exceed this
LOGITS_RTOL = 1e-4
PROFILE_ATTEMPTS = 3          # profiles of a realize before `breakdown` fails
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
# f32 operations outside the tensor cores: the data sheet's 67 TFLOP/s
# counts an FMA as two, and the port's kernels are built with -fmad=false,
# so every f32 add and mul issues alone: 128 lanes per SM, 132 SMs
F32_OPS_PER_S = 67e12 / 2
# 32-bit integer operations: 64 INT32 lanes per SM, half the f32 lanes
INT_OPS_PER_S = F32_OPS_PER_S / 2


class Deadline(Exception):
    pass


def _alarm(_sig, _frame):
    raise Deadline()


def say(msg):
    print(f"[{time.time() - T0:7.1f}s] {PHASE[0]}: {msg}", flush=True)


def phase(name):
    now = time.time()
    if PHASE[0] != "start":
        say(f"took {now - PHASE_T[0]:.1f} s")
    PHASE[0], PHASE_T[0] = name, now
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


def count_ops(plan, realz=None, params=None):
    """(f32, integer) operations the group's point expressions do on their
    data: the output's at each of its points, each member's at each output
    (x, y) point times its static dims (local_laplacian's 8 planes),
    without the halo the kernel recomputes. The coordinate arithmetic of a
    read's indices is not counted unless the index depends on data; an
    operation is counted by its operands' type (a float comparison is an
    f32 operation); an inline reduction counts its value's operations at
    every point of its RDom, and one combine a point (`point_ops`). A
    member's update counts its predicates at every point of its RDom and
    its values at the points that pass them on this run's data (`realz`,
    the inputs of `group_calls`; compositing's `where` passes one blend
    mode a layer), a mux at an RVar counting the branch it takes
    (`member_ops`, `update_passing`)."""
    from halide_tpu_torch.ops import group_kernel as gk

    def ops(m):
        passing = (gk.update_passing(m, realz, params, "cuda")
                   if m.updates and realz is not None else None)
        return np.array(gk.member_ops(m, passing), np.int64)
    per_xy = plan.extents[plan.xi] * (
        plan.extents[plan.yi] if plan.yi is not None else 1)
    total = np.array(gk.point_ops(plan.value), np.int64) * int(
        np.prod(plan.extents))
    for m in plan.members:
        total += ops(m) * per_xy * int(np.prod(
            [e for k, _d, _o, e in m.dims if k == "s"]))
    return int(total[0]), int(total[1])


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


PORT_KERNELS = ("group_", "scan_segments", "rowhist_blocks")


def port_launches():
    """Launches of the port's kernels so far, all wrappers together."""
    from halide_tpu_torch.ops import group_kernel as gk
    from halide_tpu_torch.ops import rowhist_kernel as rk
    from halide_tpu_torch.ops import scan_kernel as sk
    return gk.launches + rk.launches + sum(sk.launches.values())


def breakdown(app):
    """Where one realize's time goes: host wall time, the device's busy
    time from the profiler's kernel events, split between the port's
    kernels and the torch ops around them, and the kernels by device
    time. A profile that holds fewer records of the port's kernels than
    the realize launched is unsound: the realize is profiled again, and
    the phase fails after PROFILE_ATTEMPTS such profiles."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    app.realize()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_ATTEMPTS):
        n0 = port_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # the profiler can lose the first kernel records of a session
            # (seen on the H100 once a process has profiled the port's
            # kernels and run many launches; nl_means's group kernel was
            # among them, in one run of three even behind these): eight
            # short spins go first and are left out of the count
            for _ in range(8):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            t = time.perf_counter()
            app.realize()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
        launched = port_launches() - n0
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and \
                    "spin_kernel" not in e.name:
                us, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        mine = [(us, n) for name, (us, n) in by_name.items()
                if any(k in name for k in PORT_KERNELS)]
        held = sum(n for _us, n in mine)
        if held == launched:
            break
        say(f"{app.name}: the profile holds {held} records of the port's "
            f"kernels, the realize launched {launched}: profile "
            f"{attempt + 1} of {PROFILE_ATTEMPTS} unsound")
    else:
        raise SystemExit(f"{app.name}: {PROFILE_ATTEMPTS} profiles lost "
                         "records of the port's kernels")
    busy = sum(us for us, _n in by_name.values())
    ours = sum(us for us, _n in mine)
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


def check_replay(app, eager=None, exact=True):
    """The app's plan replayed as one CUDA graph (plan_graph) against an
    eager realize on the same inputs: realize until its graph is captured
    and replayed, and hold the last output against `eager` (an eager
    realize's outputs; by default a new Pipeline's over the same outputs,
    a plan miss): bit for bit, shape and strides too, or, with `exact`
    False (the float scatters, whose sums change order from run to run),
    by `spread`'s rule. Fails where the plan did not replay."""
    import halide_tpu_torch as hl
    from halide_tpu_torch import plan_graph
    r0, f0 = plan_graph.replays, plan_graph.fallbacks
    for _ in range(plan_graph._CAPTURE_HIT + 1):
        got = app.realize()
    torch.cuda.synchronize()
    n = plan_graph.replays - r0
    if n < 1 or plan_graph.fallbacks != f0:
        raise SystemExit(f"{app.name}: its plan did not replay ({n} "
                         f"replays; {plan_graph.last_fallback!r})")
    if eager is None:
        eager = hl.Pipeline(app.pipeline.outputs).realize(app.output_sizes)
    got, eager = (list(o) if isinstance(o, (list, tuple)) else [o]
                  for o in (got, eager))
    worst = 0.0
    for g, e in zip(got, eager):
        a, b = g.data, e.data
        if (a.shape, a.stride(), a.dtype) != (b.shape, b.stride(), b.dtype):
            raise SystemExit(f"{app.name}: the replay's output is "
                             f"{(a.shape, a.stride(), a.dtype)}, the eager "
                             f"realize's {(b.shape, b.stride(), b.dtype)}")
        if exact:
            if not torch.equal(a, b):
                raise SystemExit(f"{app.name}: the replay's output differs "
                                 "from the eager realize's")
            continue
        d = (a.double() - b.double()).abs()
        worst = max(worst, d.max().item())
        bad = (d > app.atol + app.tolerance * b.double().abs()).double() \
            .mean().item()
        if bad > app.mismatch_frac:
            raise SystemExit(f"{app.name}: the replay's output differs from "
                             f"the eager realize's beyond the app's rule on "
                             f"{bad!r} of the points")
    say(f"{app.name}: {n} replays of its plan's CUDA graph; the last "
        + ("bit for bit the eager realize" if exact else
           f"within the app's tolerance of the eager realize (max abs "
           f"{worst!r})"))


def run_app(app, data, tile_note, tol, rtol=0.0, frac=0.0, cap=math.inf,
            walks=(False,), bands=None, golden=None, exact_replay=True):
    """One app on the main path: realize on the card with the counts at 0
    (one K1 launch per group, `len(walks)`, each a band walk where `walks`
    says so, and no rejected plan), then hold each group's kernel against
    its plain version on the same arguments (|k - p| <= tol + rtol |p| on
    all but a share `frac` of the points, and |k - p| <= `cap` on every
    point) and the output against the golden (the app's own rule). With
    `bands`, the plain version evaluates only the sub-tiles of the first
    and the last `bands` bands, and the two are compared on the output rows
    those cover. Last, the plan replayed as a CUDA graph against an eager
    realize (`check_replay`, `exact_replay`). -> (the main path's group
    calls, its launches, the largest max abs error against the plain
    version, the plain versions' ms, one call each)."""
    from halide_tpu_torch.ops import group_kernel as gk
    gk.launches = 0
    gk.rejects.clear()
    out = app.realize()                    # the main path
    torch.cuda.synchronize()
    launches, rejects = gk.launches, dict(gk.rejects)
    calls = gk.group_calls(app.pipeline)
    say(f"{tile_note}: realize ok, kernel launches {launches}, "
        f"rejects {rejects}, plans {[c[0].record() for c in calls]}")
    if launches != len(walks) or rejects or len(calls) != len(walks):
        raise SystemExit(f"{app.name}: the main path did not go through "
                         f"the group kernel {len(walks)} times (launches "
                         f"{launches}, rejects {rejects})")
    got = [c[0].band_walk for c in calls]
    if got != list(walks):
        raise SystemExit(f"{app.name}: band walks {got}, expected {walks}")
    for plan, *_rest in calls:
        rec = plan.record()
        want = (gk._cdiv(plan.extents[plan.xi], plan.sx),
                gk._cdiv(plan.extents[plan.yi], plan.sy)
                if plan.yi is not None else 1)
        if rec["sub_tiles"] != want or rec["grid"] != want:
            raise SystemExit(f"{app.name}: {plan.f.name}'s sub-tiles "
                             f"{rec['sub_tiles']} and grid {rec['grid']} are "
                             f"not the {want} sub-tiles of its extent, one "
                             "a block")
    grids = [(c[0].f.name, list(c[0].extents), c[0].record()["grid"])
             for c in calls]
    say("every group's grid is its cdiv(extent, sub-tile) sub-tiles, one "
        f"a block: {grids}")
    err = plain_ms = 0.0
    for plan, inputs, rmins, params, _realz in calls:
        kern = gk.launch(plan, inputs, rmins)
        rows, where = None, "every row"
        if bands is not None:
            n = plan.ncy
            k = gk._cdiv(bands * plan.ty, plan.sy)
            rows = set(range(min(k, n))) | set(range(max(n - k, 0), n))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = gk.run_plain(plan, inputs, rmins, params, inputs[0].device,
                             rows)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if rows is not None:
            ys = gk.plain_rows(plan, rows)
            sel = torch.tensor(ys, device=kern.device)
            dim = kern.ndim - 1 - plan.yi
            kern, plain = kern.index_select(dim, sel), plain.index_select(
                dim, sel)
            first = gk.plain_rows(plan, range(min(k, n)))
            last = gk.plain_rows(plan, range(max(n - k, 0), n))
            where = (f"output rows {first[0]}-{first[-1]} and {last[0]}-"
                     f"{last[-1]} of {plan.extents[plan.yi]} (the first and "
                     f"last {bands} of {plan.nty} bands' height)")
        diff = (kern.double() - plain.double()).abs()
        e = diff.max().item()
        bad = (diff > tol + rtol * plain.double().abs()).double().mean() \
            .item()
        say(f"kernel vs plain version, {plan.f.name} over "
            f"{list(plan.extents)}, {where} ({ms / 1e3:.1f} s): max abs err "
            f"{e!r} (allowed {cap}), share beyond {tol} + {rtol} |p| {bad!r} "
            f"(allowed {frac})")
        if not (bad <= frac and e <= cap):
            raise SystemExit(f"{app.name}: kernel disagrees with its plain "
                             f"version: {bad} of the points beyond {tol} + "
                             f"{rtol} |p|, max abs err {e}")
        err, plain_ms = max(err, e), plain_ms + ms
    check_golden(app.name, out.to_numpy(),
                 app.reference(**data) if golden is None else golden,
                 app.tolerance, app.atol, app.mismatch_frac)
    check_replay(app, exact=exact_replay)
    return calls, launches, err, plain_ms


def plan_groups(apps):
    """Realize each (bound) app once with its groups planned and not
    computed (`group_kernel.planning`) and its whole-array stages' kernels
    planned and not built (`stage_kernel.collecting`), so that every
    group's and stage's source is known before any kernel runs. A rejected
    plan fails. -> (the group plans, the stage kernels' specs)."""
    from halide_tpu_torch.ops import group_kernel as gk
    from halide_tpu_torch.ops import stage_kernel as sk
    plans = []
    gk.rejects.clear()
    with gk.planning(lambda plan, *_a: plans.append(plan)), \
            sk.collecting() as stages:
        for app in apps:
            app.realize()
    if gk.rejects:
        raise SystemExit(f"rejected group plans: {dict(gk.rejects)}")
    return plans, stages


def div8_group(width, height, seed=0):
    """A tile of width x height f32 reading a producer at (x / 8, y / 8):
    src (root, 1/8 resolution) -> p (at the tiles, reads src at x / 8 and
    (x + 7) / 8) -> c (tiled 256x64). The JAX package repeats src 8-fold in
    the kernel (eval_jnp._reshape_repeat_ok, P4); K1 stages it as a d = 8
    window. -> (pipeline, sizes, the f32 golden)."""
    import halide_tpu_torch as hl
    x, y = hl.Var("x"), hl.Var("y")
    xo, yo, xi, yi = hl.Var("xo"), hl.Var("yo"), hl.Var("xi"), hl.Var("yi")
    inp = hl.ImageParam(hl.Float(32), 2, "coarse")
    a = np.random.default_rng(seed).random(
        (height // 8 + 2, width // 8 + 2), np.float32)
    inp.set(torch.from_numpy(a).cuda())
    src, p, c = hl.Func("src"), hl.Func("p"), hl.Func("c")
    src[x, y] = hl.repeat_edge(inp)[x, y] * 3 + 1
    p[x, y] = src[x / 8, y / 8] + src[(x + 7) / 8, (y - 1) / 8] * 2
    c[x, y] = p[x, y] + p[x + 1, y]
    src.compute_root()
    c.tile(x, y, xo, yo, xi, yi, 256, 64)
    p.compute_at(c, xo)
    f32 = np.float32
    s = a * f32(3) + f32(1)
    h8, w8 = s.shape
    X, Y = np.arange(width + 1), np.arange(height)[:, None]

    def at(ix, iy):
        return s[np.clip(iy, 0, h8 - 1), np.clip(ix, 0, w8 - 1)]
    pv = at(X // 8, Y // 8) + at((X + 7) // 8, (Y - 1) // 8) * f32(2)
    return hl.Pipeline(c), [width, height], pv[:, :-1] + pv[:, 1:]


def intrinsic_group(m, dtype, a, b, tile=None):
    """out[x, y] over the integer Type of numpy dtype `dtype`: the xor of
    these operations of a and b, so that each point does all of them and a
    wrong bit in any shows: floor division and modulo, popcount, clz, ctz,
    division and remainder rounded toward zero, a logical or arithmetic
    shift through reinterpret, and, for 32 and 64 bits, recip of the bits
    read as a float (the exponent's top bit cleared and the next one set: a
    normal float in, no inf, NaN or subnormal, which XLA's CPU flushes to
    0), read back as bits. `m` is the package (this port, or the JAX
    package in the tests); `a` and `b` are set on the ImageParams as given
    (tensors for the port). With `tile` the output is tiled over x, y: the
    group kernel's path, with a and b its windows. -> the pipeline."""
    bits = np.dtype(dtype).itemsize * 8
    signed = np.dtype(dtype).kind == "i"
    t = m.Int(bits) if signed else m.UInt(bits)
    A, B = m.ImageParam(t, 2, "a"), m.ImageParam(t, 2, "b")
    x, y = m.Var("x"), m.Var("y")
    av, bv = A[x, y], B[x, y]
    other = m.UInt(bits) if signed else m.Int(bits)
    planes = [av / bv, av % bv, m.popcount(av),
              m.count_leading_zeros(av), m.count_trailing_zeros(av),
              m.div_round_to_zero(av, bv), m.mod_round_to_zero(av, bv),
              m.reinterpret(t, m.reinterpret(other, av) >> 1)]
    if bits >= 32:
        top = (av >> (bits - 1)) << (bits - 1)
        finite = top | m.cast(t, 1 << (bits - 3)) \
            | (av & m.cast(t, (1 << (bits - 2)) - 1))
        planes.append(m.reinterpret(t, m.fast_inverse(
            m.reinterpret(m.Float(bits), finite))))
    value = planes[0]
    for p in planes[1:]:
        value = value ^ p
    out = m.Func("intrinsics")
    out[x, y] = value
    if tile is not None:
        xo, yo, xi, yi = m.Var("xo"), m.Var("yo"), m.Var("xi"), m.Var("yi")
        out.tile(x, y, xo, yo, xi, yi, tile[0], tile[1])
    A.set(a)
    B.set(b)
    return m.Pipeline(out)


def let_group(m, dtype, a, tile=None):
    """c[x, y] = max(p[x, y], p[x + 1, y + 1]) over inp of numpy dtype
    `dtype` (int32, float32, float16 or bfloat16), where p's value is a
    hand-built expr.Let: v = e[x - 1, y] + e[x + 1, y + 1] in v * v + v,
    with e the edge-clamped input. `m` is the package (this port, or the
    JAX package in the tests); `a` is set on the ImageParam as given (a
    tensor of `dtype` for the port). With `tile` the output is tiled and p
    computed at the tiles: the group kernel's path, with a Let and, for the
    16-bit floats, operations rounded to the type. -> the pipeline."""
    import importlib
    E = importlib.import_module(m.__name__ + ".expr")
    t = {"int32": m.Int(32), "float32": m.Float(32), "float16": m.Float(16),
         "bfloat16": m.BFloat(16)}[dtype]
    inp = m.ImageParam(t, 2, "inp")
    x, y = m.Var("x"), m.Var("y")
    e = m.repeat_edge(inp)
    p, c = m.Func("p"), m.Func("c")
    s = e[x - 1, y] + e[x + 1, y + 1]
    v = E.Variable("v", s.dtype)
    p[x, y] = E.Let("v", s, v * v + v)
    c[x, y] = m.max(p[x, y], p[x + 1, y + 1])
    if tile is not None:
        xo, yo, xi, yi = m.Var("xo"), m.Var("yo"), m.Var("xi"), m.Var("yi")
        c.tile(x, y, xo, yo, xi, yi, tile[0], tile[1])
        p.compute_at(c, xo)
    inp.set(a)
    return m.Pipeline(c)


def u64_pipeline(m, a, b, f):
    """out[x, y, c] in u64 of u64 inputs a, b and an f64 input f: plane c
    is one operation that reads u64 as unsigned (or wraps): +, -, *, /, %,
    min, max, the compares, shifts by b mod 64 and by b, absd, conversion
    to f64 and f32 (as bits), and f converted to u64. `m` and the inputs
    as `intrinsic_group`'s. -> (pipeline, the numpy golden of numpy a, b,
    f)."""
    t = m.UInt(64)
    A, B = m.ImageParam(t, 2, "a"), m.ImageParam(t, 2, "b")
    F = m.ImageParam(m.Float(64), 2, "f")
    x, y, c = m.Var("x"), m.Var("y"), m.Var("c")
    av, bv, fv = A[x, y], B[x, y], F[x, y]
    s = bv % 64
    one, two = m.cast(t, 1), m.cast(t, 2)
    planes = [av + bv, av - bv, av * bv, av / bv, av % bv,
              m.min(av, bv), m.max(av, bv),
              m.select(av < bv, one, 0) + m.select(av <= bv, two, 0)
              + m.select(av > bv, m.cast(t, 4), 0),
              av >> s, av << s, av >> bv, m.absd(av, bv),
              m.reinterpret(t, m.cast(m.Float(64), av)),
              m.cast(t, m.reinterpret(m.UInt(32), m.cast(m.Float(32), av))),
              m.cast(t, fv)]
    out = m.Func("u64_ops")
    out[x, y, c] = m.mux(c, planes)
    A.set(a)
    B.set(b)
    F.set(f)

    def golden(a, b, f):
        u = np.uint64
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            sh = b % u(64)
            fz = np.where(np.isnan(f) | (f < 0), 0.0, f)
            fu = np.where(fz >= 2.0 ** 64, np.iinfo(u).max,
                          np.minimum(fz, 2.0 ** 64 - 2048).astype(u))
            out = [a + b, a - b, a * b, np.where(b == 0, u(0), a // np.maximum(
                b, u(1))), np.where(b == 0, u(0), a % np.maximum(b, u(1))),
                np.minimum(a, b), np.maximum(a, b),
                (a < b) * u(1) + (a <= b) * u(2) + (a > b) * u(4),
                a >> sh, a << sh, np.where(b >= u(64), u(0), a >> sh),
                np.where(a > b, a - b, b - a),
                a.astype(np.float64).view(u),
                a.astype(np.float32).view(np.uint32).astype(u), fu]
        return np.stack([np.asarray(o, u) for o in out])
    return m.Pipeline(out), golden


def run_whole(app, data, note):
    """An app whose schedule tiles nothing: realize on the card with K1's
    counts at 0 (they must stay 0: every stage whole-array), and the output
    against the golden under the app's own rule."""
    from halide_tpu_torch.ops import group_kernel as gk
    gk.launches = 0
    gk.rejects.clear()
    out = app.realize()
    torch.cuda.synchronize()
    say(f"{note}: realize ok, group kernel launches {gk.launches}, rejects "
        f"{dict(gk.rejects)}")
    if gk.launches or gk.rejects:
        raise SystemExit(f"{app.name}: the whole-array schedule launched "
                         "the group kernel or planned a group")
    check_golden(app.name, out.to_numpy(), app.reference(**data),
                 app.tolerance, app.atol, app.mismatch_frac)


def intrinsic_inputs(dtype, width, height, seed=0):
    """a, b over the whole range of `dtype` on the card, b with a zero every
    fifth element and a one every seventh, and all ones (-1 or the maximum)
    every eleventh."""
    info = np.iinfo(dtype)
    rng = np.random.default_rng(seed)
    a, b = (rng.integers(info.min, info.max, width * height, endpoint=True,
                         dtype=dtype) for _ in range(2))
    b[::5] = 0
    b[1::7] = 1
    b[2::11] = -1 if info.min < 0 else info.max
    return (torch.from_numpy(v.reshape(height, width)).cuda()
            for v in (a, b))


def k3_inputs(lin_h, K):
    """K3's inputs beyond hist's lin: at its shape the same values in the
    transposed layout (neighbouring rows adjacent: rows_fast), in a view
    offset by one element (16-byte loads after a head of three elements a
    row), and cut to 1535 columns, contiguous (rows of a width that is not
    a multiple of 4: 4-byte loads); the two contention inputs, made without
    randomness (one bin a row, lin[r, :] = r % K, as a flat image region
    gives; a ramp, lin[r, p] = (p K) // P, runs of P / K equal bins, as a
    smooth gradient gives); and bins uniform in [-2, K + 3) from a seeded
    generator in 256 rows of 65,536 and in 64 rows of 262,144 (too few rows
    to fill the card: the plan splits each row over a cluster)."""
    R, P = lin_h.shape
    dev = lin_h.device
    flat = torch.empty(R * P + 1, device=dev, dtype=torch.int32)
    flat[1:] = lin_h.reshape(-1)
    r = torch.arange(R, device=dev, dtype=torch.int32)[:, None]
    p = torch.arange(P, device=dev, dtype=torch.int64)[None, :]
    gen = torch.Generator(device=dev).manual_seed(0)

    def uniform(rows, pixels):
        return torch.randint(-2, K + 3, (rows, pixels), generator=gen,
                             device=dev, dtype=torch.int32)
    return {"rows_fast": lin_h.t().contiguous().t(),
            "offset": flat[1:].view(R, P),
            "odd_width": lin_h[:, :P - 1].contiguous(),
            "one_bin": (r % K).expand(R, P).contiguous(),
            "ramp": ((p * K) // P).to(torch.int32).expand(R, P).contiguous(),
            "long_rows": uniform(256, 65536),
            "cluster": uniform(64, 262144)}


def k3_build(defines=(), patches=()):
    """A build of K3's source (csrc/rowhist_kernel.cu) with `defines`
    ((name, value) pairs) put before it and `patches` ((old, new) pairs,
    each old found once) made in it, bound as the default build is: the
    builds with parts compiled out (ROWHIST_PART) and tools/k3_sweep.py's
    variants."""
    from halide_tpu_torch.ops import build
    from halide_tpu_torch.ops import rowhist_kernel as rk
    text = (build.CSRC / "rowhist_kernel.cu").read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"K3 source patch not found once: {old!r}")
        text = text.replace(old, new)
    text = "".join(f"#define {k} {v}\n" for k, v in defines) + text
    key = build.source_key("rowhist_kernel", text)
    cu = build.BUILD_DIR / f"{key}.cu"
    cu.parent.mkdir(parents=True, exist_ok=True)
    cu.write_text(text)
    return rk.bind(build.load(key, cu))


def k3_call(lib, lin, K, scale, plan=None):
    """K3 of the build `lib` on a CUDA lin at the rule's plan with `plan`
    forced (not counted as a launch of the main path) -> the counts."""
    from halide_tpu_torch.ops import rowhist_kernel as rk
    out = torch.empty((lin.shape[0], K), dtype=torch.float32,
                      device=lin.device)
    rc = rk.call(lib, lin, K, scale, out,
                 torch.cuda.current_stream(lin.device).cuda_stream, plan)
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {rc}")
    return out


def argmax_pipeline(m, a):
    """An integer argmax over a 5 x 4 RDom of an int32 image `a` (values in
    a few levels, so that most windows tie): (r.x, r.y, value) of the first
    maximal point with r.x the most significant, against numpy's argmax of
    each window flattened so. -> (pipeline, output sizes, golden)."""
    x, y = m.Var("x"), m.Var("y")
    inp = m.ImageParam(m.Int(32), 2, "am_in")
    inp.set(torch.from_numpy(a).cuda())
    r = m.RDom(0, 5, 0, 4, "am")
    f = m.Func("argmax_2d")
    am = m.argmax(inp[x + r.x, y + r.y])
    f[x, y] = (am[0], am[1], am[2])
    h, w = a.shape
    win = np.lib.stride_tricks.sliding_window_view(a, (4, 5))  # [y,x,ry,rx]
    flat = win.transpose(0, 1, 3, 2).reshape(h - 3, w - 4, 20)
    i = flat.argmax(axis=2)
    golden = [(i // 4).astype(np.int32), (i % 4).astype(np.int32),
              np.take_along_axis(flat, i[..., None], 2)[..., 0]]
    return m.Pipeline(f), [w - 4, h - 3], golden


def reduction_app(app, data, note, ref_ms=None):
    """An app of inline reductions or contraction updates on the main path:
    realize on the card (no group kernel: whole-array stages and updates),
    the output against its golden, the lowering its updates and inline
    reductions took, the plan replayed as a CUDA graph bit for bit that
    realize (`check_replay`), and its realize time (CUDA events after a
    warm-up, L2 flushed) beside the reference Halide's GPU time where there
    is one.
    The convolution and einsum calls of one realize are kept and timed
    alone (device time, at full precision as the port runs them). -> the
    row of times."""
    from halide_tpu_torch import eval_torch, updates
    from halide_tpu_torch.ops import group_kernel as gk
    # a plan miss: the realize runs eager, and makes the calls counted
    # below (a replay of the plan's CUDA graph makes none of them)
    app.pipeline._plan_cache.clear()
    updates._last_reduce_path.clear()
    inline0 = dict(eval_torch.reduce_paths)
    gk.launches = 0
    gk.rejects.clear()
    (out, convs), einsums = capture(torch, "einsum", lambda: capture(
        torch.nn.functional, "conv2d", app.realize))
    torch.cuda.synchronize()
    inline = {k: v - inline0.get(k, 0)
              for k, v in eval_torch.reduce_paths.items()
              if v != inline0.get(k, 0)}
    say(f"{note}: realize ok, group kernel launches {gk.launches}, rejects "
        f"{dict(gk.rejects)}; update lowering {dict(updates._last_reduce_path)}"
        f", inline reductions {inline}")
    if gk.launches or gk.rejects:
        raise SystemExit(f"{app.name}: planned or launched a group")
    outs = out if isinstance(out, (list, tuple)) else [out]
    refs = app.reference(**data)
    refs = refs if isinstance(refs, (list, tuple)) else [refs]
    for o, r in zip(outs, refs):
        check_golden(app.name, o.to_numpy(), r, app.tolerance, app.atol,
                     app.mismatch_frac)
    check_replay(app, outs)
    return {"app": app.name, "paths": dict(updates._last_reduce_path),
            "inline": inline, "convs": convs, "einsums": einsums,
            "reference_gpu_ms": ref_ms}


def z_in_window(app, plan, data):
    """bilateral_grid's slice reads blury at the data-dependent plane
    zi2 + dz, dz in {0, 1}, zi2 = i32(clamp(input, 0, 1) / r_sigma): the
    planes this run's input reaches must lie inside the static z dim of
    the staged blury window (the kernel also clamps the index into it)."""
    inp = torch.from_numpy(data["input"]).cuda()
    zi = (inp.clamp(0.0, 1.0) * np.float32(1.0 / 0.1)).to(torch.int32)
    lo_z, hi_z = int(zi.min()), int(zi.max()) + 1
    w = next(w for w in plan.windows if w.name == "blury")
    kind, _d, off, ext = w.dims[2]
    say(f"{app.name}: blury's z planes read by this input [{lo_z}, {hi_z}],"
        f" its staged window's z dim {kind} [{off}, {off + ext - 1}]")
    if kind != "s" or lo_z < off or hi_z > off + ext - 1:
        raise SystemExit(f"{app.name}: the slice reads z planes outside "
                         "the staged window")


def spread(app, ref):
    """The float scatters of bilateral_grid's and bgu's grid construction
    (updates._dense_small_scatter, a scatter_add_ by atomics on the card)
    sum in an order that may change from run to run: two realizes on the
    same inputs, their largest difference and the share of points beyond
    the app's tolerance of each other, and the largest difference from the
    golden. Fails where either passes the app's rule."""
    a = app.realize().to_numpy().astype(np.float64)
    b = app.realize().to_numpy().astype(np.float64)
    rf = np.asarray(ref, np.float64)
    d_run = float(np.abs(a - b).max())
    bad = float((np.abs(a - b) > app.atol + app.tolerance
                 * np.abs(b)).mean())
    d_ref = max(float(np.abs(a - rf).max()), float(np.abs(b - rf).max()))
    bad_ref = max(float((np.abs(x - rf) > app.atol + app.tolerance
                         * np.abs(rf)).mean()) for x in (a, b))
    say(f"{app.name}: two realizes on the same inputs differ by at most "
        f"{d_run!r} (share beyond rtol {app.tolerance} / atol {app.atol}: "
        f"{bad!r}); from the golden by at most {d_ref!r} (share beyond: "
        f"{bad_ref!r}; allowed {app.mismatch_frac})")
    if bad > app.mismatch_frac or bad_ref > app.mismatch_frac:
        raise SystemExit(f"{app.name}: the run-to-run spread or the golden "
                         "difference passes the app's tolerance")
    return {"run_to_run_max_abs": d_run, "golden_max_abs": d_ref}


def slice2_apps(app_co, app_bg, app_bgu, data, card, k1_row, flush):
    """The phase of the last image apps at their canonical sizes
    (BASELINE.md:7-11): compositing, bilateral_grid and bgu on the main
    path through K1 (one launch each, held against the plain version on
    the rows of the first and the last band, compositing exactly, the
    float slices within rtol 1e-5), timed beside their bounds, the whole
    realize and the idle share; bilateral_grid's and bgu's run-to-run
    spread; then resize (scale 0.5) and lens_blur (the JAX app's
    defaults) whole-array, against their goldens (lens_blur's stochastic
    default by its structure, its zero-radius case by its 1e-4)."""
    from halide_tpu_torch import eval_torch
    from halide_tpu_torch.apps import get as app_get
    from halide_tpu_torch.ops import group_kernel as gk
    k1 = "halide_tpu/ops/pallas_group.py:696"
    band = "the output rows of the first and the last band"
    rows = {}
    for app, note, rtol, ref_ms in (
            (app_co, "compositing 1536x2560, 6 u8 RGBA layers, tile "
             "256x128 (blended: (u16, u16, u16, u8), a masked 5x5 update)",
             0.0, 2.4),
            (app_bg, "bilateral_grid 1536x2560 f32, tile 512x256 (the "
             "trilinear slice)", 1e-5, 0.50),
            (app_bgu, "bgu 1536x2560x3 f32, tile 512x256 (imz and the "
             "affine slice)", 1e-5, 0.92)):
        d = data[id(app)]
        golden = app.reference(**d)
        res = run_app(app, d, note, 0.0, rtol=rtol, bands=1, golden=golden,
                      exact_replay=app is app_co)
        plan = res[0][0][0]
        if app is app_bg:
            z_in_window(app, plan, d)
        row = k1_row(f"K1 stencil group ({app.name})", k1, app, res,
                     plain_on=band, reference_gpu_ms=ref_ms)
        say(f"{app.name} on {card}: the reference Halide's GPU time "
            f"{ref_ms} ms (RTX 2060)")
        if app is not app_co:
            row.update(spread(app, golden))
        breakdown(app)
        rows[app.name] = row
    # resize: its lowering, golden and einsums as the reductions phase's
    app = app_get("resize")(width=1536, height=2560, scale_factor=0.5)
    d = app.make_inputs(0)
    app.bind(d)
    row = reduction_app(app, d, "resize 1536x2560x3 f32, scale 0.5 cubic")
    with eval_torch.contract_precision():
        e_ms = sum(event_ms(lambda a=a, k=k: torch.einsum(*a, **k), 20,
                            flush, hold=True) for a, k in row["einsums"])
    r_ms = event_ms(app.realize, 10, flush)
    say(f"resize on {card}: whole realize {r_ms:.4f} ms (host, to "
        f"completion); {len(row['einsums'])} einsums {e_ms:.4f} ms "
        "(device); the reference Halide's GPU time: none published")
    breakdown(app)
    # lens_blur at the JAX app's defaults: stochastic, so its structure
    # (tests/test_apps.py:123), and its zero-radius case against its golden
    app = app_get("lens_blur")()
    d = app.make_inputs(0)
    app.bind(d)
    gk.launches = 0
    gk.rejects.clear()
    inline0 = dict(eval_torch.reduce_paths)
    got = app.realize().to_numpy()
    inline = {k: v - inline0.get(k, 0)
              for k, v in eval_torch.reduce_paths.items()
              if v != inline0.get(k, 0)}
    ok = (got.shape == (3, 320, 192) and bool(np.isfinite(got).all())
          and got.min() >= 0.0 and got.max() <= 255.0)
    say(f"lens_blur 192x320 defaults: group kernel launches {gk.launches}, "
        f"rejects {dict(gk.rejects)}, inline reductions {inline}; shape "
        f"{got.shape}, finite and in [0, 255]: {ok}")
    if gk.launches or gk.rejects or not ok:
        raise SystemExit("lens_blur: planned a group or fails its "
                         "structural checks")
    zero = app_get("lens_blur")(blur_radius_scale=0.0)
    zero.bind(d)
    check_golden("lens_blur", zero.realize().to_numpy(),
                 zero.reference(**d), zero.tolerance, zero.atol)
    # some 30,000 small torch launches a realize (over a second): three
    # timed calls, and no profile
    r_ms = event_ms(app.realize, 3, flush)
    say(f"lens_blur on {card}: whole realize {r_ms:.4f} ms (host, to "
        "completion); the reference Halide's GPU time: none published")
    say("slice2 K1 rows: " + json.dumps(
        {k: {f: r.get(f) for f in ("ms", "bound_ms", "bound_by",
                                   "realize_ms", "launches", "max_abs_err",
                                   "plain_ms", "run_to_run_max_abs",
                                   "golden_max_abs")}
         for k, r in rows.items()}))


# ---------------------------------------------------------------------------
# slice3_surface: the pipeline's surface around realize
# ---------------------------------------------------------------------------

def spec_unsharp(width, height, tile):
    """unsharp with a specialization ladder on a Param `tiled`: where it is
    >= 1, the output is tiled by `tile` and its wide producers computed at
    its tiles (the schedule `apps.tile_producers` puts on); else the app's
    default schedule, whole-array. -> (App, the Param)."""
    import halide_tpu_torch as ht
    from halide_tpu_torch.apps import TILED_PRODUCERS, unsharp
    app = unsharp.build(width, height)
    out = app.pipeline.outputs[0]
    funcs = {f.name: f for f in ht.pipeline.gather_graph([out]).funcs}
    p = ht.Param(ht.Int(32), "tiled", 0)
    x, y = out.args()[:2]
    xo, yo, xi, yi = ht.Var("xo"), ht.Var("yo"), ht.Var("xi"), ht.Var("yi")
    out.specialize(p._to_expr() >= 1).tile(x, y, xo, yo, xi, yi, *tile)
    for name in TILED_PRODUCERS["unsharp"]:
        funcs[name].specialize(p._to_expr() >= 1).compute_at(out, xo)
    return app, p


def deserialized(app):
    """`app` with its pipeline written by the serializer and read back:
    new Funcs, ImageParams and Params, bound by name from the same numpy
    inputs. -> (App over the read-back pipeline, the text)."""
    import halide_tpu_torch as ht
    from halide_tpu_torch.apps import App
    text = ht.serialize_pipeline(app.pipeline)
    pipe, images, params = ht.deserialize_pipeline(text)
    new = App(f"{app.name}_read_back", pipe,
              list(images.values()) + list(params.values()),
              app.make_inputs, app.reference, app.output_sizes,
              tolerance=app.tolerance, atol=app.atol,
              mismatch_frac=app.mismatch_frac)
    return new, text


def memo_camera_pipe(out_width, out_height, tile):
    """camera_pipe's kernel branch with its tone curve `curve` (1,024 u8
    entries, inline in the app) computed at root and memoized: the group's
    `curved` member reads it as a window. -> App."""
    import halide_tpu_torch as ht
    from halide_tpu_torch.apps import camera_pipe
    app = camera_pipe.build(out_width, out_height, kernel=True, tile=tile)
    funcs = {f.name: f for f in ht.pipeline.gather_graph(
        app.pipeline.outputs).funcs}
    funcs["curve"].compute_root().memoize()
    return app


def extern_blur(width, height, tile):
    """blur (the README schedule, tiled `tile`) over an extern stage that
    produces its input on the host: the input xor 0x1234, in u16. ->
    (pipeline, the ImageParam the extern reads, the golden of numpy
    inputs)."""
    import halide_tpu_torch as ht
    from halide_tpu_torch.apps import blur
    x, y = ht.Var("x"), ht.Var("y")
    xo, yo, xi, yi = ht.Var("xo"), ht.Var("yo"), ht.Var("xi"), ht.Var("yi")
    raw = ht.ImageParam(ht.UInt(16), 2, "raw")
    src = ht.Func("blur_src")
    src.define_extern("blur_src", lambda a: np.bitwise_xor(a, 0x1234),
                      [raw], output_type=ht.UInt(16), dimensions=2)
    blur_x, blur_y = ht.Func("blur_x"), ht.Func("blur_y")
    blur_x[x, y] = (src[x, y] + src[x + 1, y] + src[x + 2, y]) / 3
    blur_y[x, y] = (blur_x[x, y] + blur_x[x, y + 1] + blur_x[x, y + 2]) / 3
    blur_y.tile(x, y, xo, yo, xi, yi, *tile).vectorize(xi).parallel(yo)
    blur_x.compute_at(blur_y, xo)
    ref = blur.build(width, height).reference

    def golden(a):
        return ref(np.bitwise_xor(a, np.uint16(0x1234)))
    return ht.Pipeline(blur_y), raw, golden


def read_trace(path):
    """The packets of a trace file: [(event, name, payload bytes)]."""
    raw = open(path, "rb").read()
    out, off = [], 0
    while off < len(raw):
        hdr = np.frombuffer(raw[off:off + 56], np.uint32)
        assert hdr[0] == 0x48545243, "bad packet magic"
        n_name, n_pay = int(hdr[2]), int(hdr[3])
        name = raw[off + 56:off + 56 + n_name].decode()
        pay = raw[off + 56 + n_name:off + 56 + n_name + n_pay]
        out.append((int(hdr[1]), name, pay))
        off += 56 + n_name + n_pay
    return out


def slice3_surface(card, timer, dev, sizes, apps):
    """The phase of the surface around realize, at the canonical sizes
    (`sizes`): specialize, serialize, trace, profile, memoize, an extern
    stage and debug_to_file, each on the port's entry points with every
    kernel count at 0 just before and read just after; `timer(fn, n)` is
    the median of n timed calls (CUDA events on the card). Fails the run
    on any disagreement. -> a dict of the numbers it prints."""
    import tempfile

    import halide_tpu_torch as ht
    from halide_tpu_torch import pipeline as tp
    from halide_tpu_torch.ops import group_kernel as gk
    from halide_tpu_torch.ops import rowhist_kernel as rk
    from halide_tpu_torch.ops import scan_kernel as sk
    from halide_tpu_torch.runtime import memo_cache
    from halide_tpu_torch.trace import tracing
    out = {}

    def counts0():
        gk.launches = rk.launches = 0
        sk.launches["const"] = sk.launches["general"] = 0
        gk.rejects.clear()

    def counts():
        sync()
        return {"K1": gk.launches, "K2a": sk.launches["const"],
                "K2b": sk.launches["general"], "K3": rk.launches,
                "rejects": dict(gk.rejects)}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def fail(msg):
        raise SystemExit(f"slice3_surface: {msg}")

    # specialize: the tiled branch through K1, the other whole-array; each
    # timed in turns beside the same schedule put on without a ladder
    app_s, p_s = apps["spec"]
    golden = app_s.reference(**apps["spec_data"])
    for tiled, same in ((1, apps["spec_tiled"]), (0, apps["spec_default"])):
        p_s.set(tiled)
        counts0()
        got = app_s.realize(dev)
        n = counts()
        check_golden(f"unsharp specialized tiled={tiled}", got.to_numpy(),
                     golden, app_s.tolerance, app_s.atol)
        if n["K1"] != tiled or n["rejects"]:
            fail(f"unsharp tiled={tiled}: launches {n}")
        ms = [timer(lambda a=a: a.realize(dev), 10)
              for a in (same, app_s, app_s, same)]
        out[f"spec_tiled{tiled}_ms"] = (ms[1] + ms[2]) / 2
        out[f"spec_tiled{tiled}_no_ladder_ms"] = (ms[0] + ms[3]) / 2
        say(f"unsharp 1536x2560x3, specialize(tiled >= 1), tiled={tiled}: "
            f"counts {n}; realize {ms[1]:.4f}, {ms[2]:.4f} ms, the same "
            f"schedule without a ladder {ms[0]:.4f}, {ms[3]:.4f} ms (in "
            f"turns) on {card}")

    # serialize: read back, realize, the same bits, kernels and plan
    for app, rb, data, kern in apps["serial"]:
        counts0()
        gk.last_plan = None
        want = app.realize(dev).to_numpy()
        n0, plan0 = counts(), gk.last_plan
        gk.last_plan = None
        rb.bind(data, dev)
        counts0()
        got = rb.realize(dev).to_numpy()
        n1, plan1 = counts(), gk.last_plan
        same = got.dtype == want.dtype and np.array_equal(got, want)
        # the plan's geometry; its op count ("model") is the source's, and
        # the reader merges equal subtrees that the original built apart
        geo0, geo1 = ({k: v for k, v in (q or {}).items() if k != "model"}
                      for q in (plan0, plan1))
        ops = [q and q["model"]["ops_per_out"] for q in (plan0, plan1)]
        say(f"{app.name} read back from its text: bit for bit {same}; "
            f"counts {n1} (the original's {n0}); K1 plan geometry the same "
            f"{geo1 == geo0} ({geo1.get('sub_tile')}, "
            f"{geo1.get('threads')} threads, grid {geo1.get('grid')}); "
            f"operations an output {ops[1]} (the original's {ops[0]})")
        if not same or n1 != n0 or n1[kern] < 1 or geo1 != geo0:
            fail(f"{app.name}: the read-back pipeline differs")
        out[f"serial_{app.name}_ms"] = timer(lambda: rb.realize(dev), 5)

    # trace: blur under trace_all (every Func armed), then to a file
    app_t = apps["trace"]
    target = "cuda-sm_90-trace_all" if dev.type == "cuda" else \
        "cpu-trace_all"
    counts0()
    app_t.pipeline.realize(app_t.output_sizes, target=target, device=dev)
    n = counts()
    if n["K1"] != 1:
        fail(f"blur under trace_all: counts {n}")
    base_ms = timer(lambda: app_t.realize(dev), 10)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/blur.trace"
        with tracing(app_t.pipeline, file=path) as t:
            counts0()
            got = app_t.realize(dev).to_numpy()
            n = counts()
            tr_ms = timer(lambda: app_t.realize(dev), 10)
        packets = read_trace(path)
        size = len(open(path, "rb").read())
    first = [pk for pk in packets[:3]]
    want_ev = {("begin_realization", "blur_y"): 12,
               ("store", "blur_y"): 12, ("end_realization", "blur_y"): 12}
    want_size = 12 * (3 * (56 + len("blur_y")) + got.nbytes)
    ok = (t.counts() == want_ev and n["K1"] == 1
          and [pk[0] for pk in first] == [2, 1, 3]
          and first[1][2] == got.tobytes() and size == want_size)
    say(f"blur 2560x1536 traced to a file: events {t.counts()} (11 of them "
        f"from the timed calls), counts {n}, store payload equal to the "
        f"output {first[1][2] == got.tobytes()}, file {size} bytes "
        f"(expected {want_size}); realize {base_ms:.4f} ms untraced, "
        f"{tr_ms:.4f} ms traced with payloads, on {card}")
    if not ok:
        fail("the trace's events, payload or size are wrong")
    out.update(trace_off_ms=base_ms, trace_on_ms=tr_ms, trace_bytes=size)

    # profile: local_laplacian, both modes
    app_l = apps["profile"]
    r_ms = timer(lambda: app_l.realize(dev), 5)
    t0 = time.perf_counter()
    rep_s = app_l.pipeline.profile(app_l.output_sizes, device=dev)
    s_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts0()
    rep_f = app_l.pipeline.profile(app_l.output_sizes, mode="fused",
                                   device=dev)
    f_s = time.perf_counter() - t0
    n = counts()
    top_s = sorted(rep_s["funcs"], key=lambda e: -e["ms"])[:5]
    top_f = sorted(rep_f["funcs"], key=lambda e: -e["ms"])[:5]
    say(f"local_laplacian profile on {card}: stages total "
        f"{rep_s['total_ms']:.4f} ms over {len(rep_s['funcs'])} stages "
        f"(the profile took {s_s:.2f} s), top "
        + "; ".join(f"{e['name']} {e['ms']:.4f} ms" for e in top_s))
    say(f"local_laplacian fused profile on {card}: total "
        f"{rep_f['total_ms']:.4f} ms (the realize by CUDA events "
        f"{r_ms:.4f} ms; the profile took {f_s:.2f} s, counts {n}), top "
        + "; ".join(f"{e['name']} {e['ms']:.4f} ms" for e in top_f))
    cums = [e["cum_ms"] for e in rep_f["funcs"]]
    if not (r_ms / 2 <= rep_f["total_ms"] <= 2 * r_ms) or n["K1"] < 1 \
            or any(e["ms"] < 0 for e in rep_f["funcs"]) \
            or rep_f["total_ms"] != cums[-1]:
        fail("the fused profile's total is not within 2x of the realize")
    out.update(profile_stages_ms=rep_s["total_ms"],
               profile_fused_ms=rep_f["total_ms"], profile_realize_ms=r_ms,
               profile_stages_s=s_s, profile_fused_s=f_s)

    # memoize: camera_pipe's tone curve from the native LRU, against the
    # same app with its curve inline (held against its golden, bit for bit,
    # in phase camera_pipe)
    app_m, same = apps["memo"], apps["memo_same"]
    want = same.realize(dev).to_numpy()
    memo_cache().clear()
    res = []
    for attempt in ("miss", "hit"):
        st0 = memo_cache().stats()
        counts0()
        sync()
        t0 = time.perf_counter()
        got = app_m.realize(dev).to_numpy()
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        st1 = memo_cache().stats()
        res.append((got, ms, dict(tp.last_memo), counts(),
                    st1["hits"] - st0["hits"]))
        say(f"camera_pipe with a memoized curve, {attempt}: realize "
            f"{ms:.4f} ms (host clock, to completion), key hashing "
            f"{tp.last_memo['key_s'] * 1e3:.4f} ms, {tp.last_memo}, counts "
            f"{res[-1][3]}, on {card}")
    (g0, ms0, m0, n0, h0), (g1, ms1, m1, n1, h1) = res
    say(f"camera_pipe with a memoized curve against the inline curve: bit "
        f"for bit {np.array_equal(g0, want)}, {np.array_equal(g1, want)}")
    if not (np.array_equal(g0, want) and np.array_equal(g1, want)
            and m0["misses"] == ["curve"] and m1["hits"] == ["curve"]
            and h1 > 0 and np.array_equal(g0, g1) and n0["K1"] == 1
            and n1["K1"] == 1):
        fail("the second realize is not a hit equal to the first")
    out.update(memo_miss_ms=ms0, memo_hit_ms=ms1,
               memo_key_ms=m1["key_s"] * 1e3)

    # an extern stage produces blur's input; K1 consumes it
    pipe_e, raw_e, golden_e, data_e = apps["extern"]
    raw_e.set(torch.from_numpy(data_e).to(dev))
    counts0()
    got = pipe_e.realize(sizes["blur"], device=dev).to_numpy()
    n = counts()
    rt = dict(tp.last_extern)
    check_golden("blur over an extern input", got, golden_e(data_e), 0, 0)
    if n["K1"] != 1 or n["rejects"]:
        fail(f"blur over the extern stage: counts {n}")
    say(f"extern stage -> blur 2560x1536 u16 through K1: counts {n}; host "
        f"round trip: {rt['bytes_out']} bytes off the card in "
        f"{rt['copy_out_s'] * 1e3:.4f} ms, callback "
        f"{rt['callback_s'] * 1e3:.4f} ms, {rt['bytes_in']} bytes back in "
        f"{rt['copy_in_s'] * 1e3:.4f} ms, on {card}")
    out.update(extern_copy_out_ms=rt["copy_out_s"] * 1e3,
               extern_callback_ms=rt["callback_s"] * 1e3,
               extern_copy_in_ms=rt["copy_in_s"] * 1e3)

    # debug_to_file: blur's compute_root producer, dumped
    app_d, data_d = apps["debug"]
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/blur_x.npy"
        bx = next(f for f in ht.pipeline.gather_graph(
            app_d.pipeline.outputs).funcs if f.name == "blur_x")
        bx.compute_root().debug_to_file(path)
        counts0()
        got = app_d.realize(dev).to_numpy()
        dumped = np.load(path)
        bx.debug_to_file(None)
    a = data_d["input"].astype(np.uint16)
    want = (a[:, :-2] + a[:, 1:-1] + a[:, 2:]) // 3
    check_golden("blur with a dump", got, app_d.reference(**data_d), 0, 0)
    ok = dumped.dtype == want.dtype and np.array_equal(dumped, want)
    say(f"blur_x (compute_root) dumped by debug_to_file: {dumped.shape} "
        f"{dumped.dtype}, equal to blur_x {ok}")
    if not ok:
        fail("the debug_to_file dump differs from the stage")
    return out


def grad_stencil(m, width, height, tile=None, seed=0):
    """A float stencil for propagate_adjoints: by = (bx[y-1] + bx^2 +
    bx[y+1]) k of bx = the edge-clamped input's 1-2-1 along x, k a Param,
    with bx computed at by's tiles where `tile` is given (K1's path). `m`
    is the port; the input is set on the card. -> (by, propagate_adjoints'
    keyword arguments)."""
    x, y = m.Var("x"), m.Var("y")
    img = m.ImageParam(m.Float(32), 2, "gin")
    cl = m.repeat_edge(img)
    bx, by = m.Func("gbx"), m.Func("gby")
    k = m.Param(m.Float(32), "k", 0.75)
    bx[x, y] = cl[x - 1, y] + 2.0 * cl[x, y] + cl[x + 1, y]
    by[x, y] = (bx[x, y - 1] + bx[x, y] * bx[x, y] + bx[x, y + 1]) * k
    if tile is not None:
        xo, yo, xi, yi = (m.Var(n) for n in ("xo", "yo", "xi", "yi"))
        by.tile(x, y, xo, yo, xi, yi, tile[0], tile[1])
        bx.compute_at(by, xo)
    a = np.random.default_rng(seed).random((height, width), np.float32)
    img.set(torch.from_numpy(a).cuda())
    return by, dict(sizes=[width, height], wrt=[img, k])


def unschedule(app):
    """Clear the compute level and compute_with of every producer of the
    app in place, so that the autoscheduler decides them all (the
    reference's apps build their auto-scheduled variant without the manual
    schedule). -> app."""
    import halide_tpu_torch as ht
    from halide_tpu_torch.schedule import LoopLevel
    for f in ht.pipeline.gather_graph(app.pipeline.outputs).funcs:
        if f not in app.pipeline.outputs:
            f._fschedule.compute_level = LoopLevel()
            for d in f._defs:
                d.schedule.fused_with = []
    return app


def auto_app(build, name, **kw):
    """The app at its default schedule, its output's estimates its sizes,
    scheduled by the autoscheduler `name`. -> (app, its report)."""
    app = build(**kw)
    for out in app.pipeline.outputs:
        out.set_estimates([(0, int(s)) for s in app.output_sizes])
    return app, app.pipeline.apply_autoscheduler(params={"name": name})


def slice3_tools(card, timer, dev, apps):
    """The phase of the autoschedulers and the tools, on the card: each
    app autoscheduled by Mullapudi2016 and Adams2019 against its golden
    and its manual schedule (the reference's "manually-tuned /
    auto-scheduled" pair, BASELINE.md:45), timed in turns; Anderson2021 on
    blur; fitcost beside the package's sm_90 row; tilesearch on blur;
    `gen -e object` of blur and hist reloaded and run; `rungen
    --benchmarks` of iir_blur; propagate_adjoints of a float stencil
    through K1 against the port on the CPU. Every kernel count is set to 0
    just before each path and read just after; `timer(fn, n)` is the
    median of n timed calls (CUDA events, L2 flushed). Fails the run on
    any disagreement. -> a dict of the numbers it prints."""
    import contextlib
    import io
    import os
    import tempfile

    import zipfile

    import halide_tpu_torch as ht
    from halide_tpu_torch import generator
    from halide_tpu_torch.ops import export_ops
    from halide_tpu_torch.ops import group_kernel as gk
    from halide_tpu_torch.ops import rowhist_kernel as rk
    from halide_tpu_torch.ops import scan_kernel as sk
    from halide_tpu_torch.tools import fitcost
    from halide_tpu_torch.tools import gen as gen_cli
    from halide_tpu_torch.tools import rungen, tilesearch
    out = {}

    def counts0():
        gk.launches = rk.launches = 0
        sk.launches["const"] = sk.launches["general"] = 0
        gk.rejects.clear()

    def counts():
        torch.cuda.synchronize()
        return {"K1": gk.launches, "K2a": sk.launches["const"],
                "K2b": sk.launches["general"], "K3": rk.launches,
                "rejects": dict(gk.rejects)}

    def fail(msg):
        raise SystemExit(f"slice3_tools: {msg}")

    def host_ms(fn, n=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    def printed(fn, *a):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fn(*a)
        for ln in buf.getvalue().splitlines():
            say(ln)
        if rc:
            fail(f"{fn.__module__} returned {rc}")
        return buf.getvalue()

    # autoscheduled apps against their goldens and manual schedules
    out["auto"] = {}
    for name, (manual, data, autos) in apps["auto"].items():
        golden = manual.reference(**data)
        want = manual.realize(dev).to_numpy()
        for sched, (app, rep) in autos.items():
            counts0()
            got = app.realize(dev).to_numpy()
            n = counts()
            check_golden(f"{name} {sched}", got, golden, app.tolerance,
                         app.atol, app.mismatch_frac)
            check_golden(f"{name} {sched} against the manual schedule", got,
                         want, app.tolerance, app.atol, app.mismatch_frac)
            plan = gk.plans_by_name.get(app.pipeline.outputs[0].name)
            if n["K1"] < 1:
                fail(f"{name} {sched}: no K1 launch ({n}, rejects "
                     f"{dict(gk.rejects_by_name)})")
            ms = [timer(lambda a=a: a.realize(dev), 10)
                  for a in (manual, app, app, manual)]
            rec = {"manual_ms": (ms[0] + ms[3]) / 2,
                   "auto_ms": (ms[1] + ms[2]) / 2, "counts": n,
                   "schedule": rep["schedule_source"],
                   "plan": plan and {k: plan[k] for k in (
                       "tile", "sub_tile", "threads", "grid", "members")}}
            rec["auto_over_manual"] = rec["auto_ms"] / rec["manual_ms"]
            out["auto"][f"{name}/{sched}"] = rec
            say(f"{name} {sched}: counts {n}; K1 plan {rec['plan']}; manual "
                f"{ms[0]:.4f}, {ms[3]:.4f} ms, auto {ms[1]:.4f}, "
                f"{ms[2]:.4f} ms (in turns; auto/manual "
                f"{rec['auto_over_manual']:.3f}) on {card}")

    # Anderson2021: its candidates realized and timed on the card
    app_an, data_an = apps["anderson"]
    res = app_an.pipeline.apply_autoscheduler(
        params={"name": "Anderson2021", "samples": 3})
    counts0()
    got = app_an.realize(dev).to_numpy()
    n = counts()
    check_golden("blur Anderson2021", got, app_an.reference(**data_an), 0, 0)
    if "autotuned" not in res or n["K1"] != 1:
        fail(f"Anderson2021 on blur: {res}, counts {n}")
    out["anderson2021"] = dict(res["autotuned"],
                               schedule=res["schedule_source"])
    say(f"Anderson2021 on blur 2560x1536: {res['autotuned']}; counts {n}; "
        f"on {card}")

    # fitcost on the card, beside the row the package holds
    text = printed(fitcost.main, [])
    line = next(ln for ln in text.splitlines() if ln.startswith("FITCOST"))
    got = {k: float(v) for k, v in (t.split("=") for t in line.split()[2:])}
    out["fitcost"] = dict(got, package_row=ht.target.FITTED_COST["sm_90"])
    say(f"fitcost on {card}: {got}; the package's sm_90 row "
        f"{ht.target.FITTED_COST['sm_90']}")

    # tilesearch on blur, a menu of three tiles
    rows = tilesearch.search("blur", apps["tiles"], None, dev,
                             out=io.StringIO())
    out["tilesearch"] = [{"label": lb, "ms": ms,
                          "sub_tile": p and p["sub_tile"]}
                         for ms, lb, p in rows]
    if len(rows) != len(apps["tiles"]) + 1:
        fail(f"tilesearch: {len(rows)} of {len(apps['tiles']) + 1} shapes "
             "realized correctly")
    say(f"tilesearch blur 2560x1536 on {card}: {out['tilesearch']}")

    # gen -e object: blur (tiled) and hist, reloaded and run on the card
    out["object"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, app, args, kern in apps["object"]:
            sizes = "x".join(str(v) for v in app.output_sizes)
            printed(gen_cli.main, ["-g", name, "-o", tmp, "-e", "object",
                                   "--sizes", sizes] + args)
            path = os.path.join(tmp, f"{name}.exported")
            with open(path, "rb") as fh:
                blob = fh.read()
            fn = generator.load_compiled(blob)
            x = [s.get().data for s in app.inputs]
            want = app.realize(dev).to_numpy()
            counts0()
            got = fn(*x)[0].cpu().numpy()
            n = counts()
            same = got.dtype == want.dtype and np.array_equal(got, want)
            if not same or n[kern] != 1:
                fail(f"{name} loaded from its exported program: bit for bit "
                     f"{same}, counts {n}")
            ms = [timer(f, 10) for f in (lambda: app.realize(dev),
                                         lambda: fn(*x), lambda: fn(*x),
                                         lambda: app.realize(dev))]
            out["object"][name] = {
                "bytes": len(blob), "counts": n,
                "loaded_ms": (ms[1] + ms[2]) / 2,
                "realize_ms": (ms[0] + ms[3]) / 2}
            if kern == "K1":
                # what a launch through the custom op costs the host,
                # against the direct ctypes launch realize makes
                with zipfile.ZipFile(io.BytesIO(blob)) as z:
                    key = next(iter(json.loads(z.read("meta.json"))[
                        "kernels"]))
                plan, mins, _params = export_ops.plans[key]
                out["object"][name].update(
                    op_launch_ms=host_ms(
                        lambda: export_ops.group_op(x, key)),
                    direct_launch_ms=host_ms(
                        lambda: gk.launch(plan, x, mins)))
                say(f"a K1 launch from the host through the custom op "
                    f"{out['object'][name]['op_launch_ms']:.4f} ms, direct "
                    f"(realize's) {out['object'][name]['direct_launch_ms']:.4f}"
                    f" ms (200 in a row, to completion) on {card}")
            say(f"{name} gen -e object ({len(blob)} bytes), loaded: bit for "
                f"bit {same}, counts {n}; loaded run {ms[1]:.4f}, "
                f"{ms[2]:.4f} ms, realize {ms[0]:.4f}, {ms[3]:.4f} ms (in "
                f"turns) on {card}")

    # rungen --benchmarks of iir_blur (K2a)
    counts0()
    text = printed(rungen.main, ["iir_blur", "--benchmarks=all",
                                 "--parsable_output"])
    n = counts()
    if n["K2a"] < 4:
        fail(f"rungen iir_blur: counts {n}")
    out["rungen_iir_blur"] = dict(json.loads(text.strip().splitlines()[-1]),
                                  counts=n)

    # propagate_adjoints through K1 on the card against the CPU. The
    # gradient comes from the backward, which recomputes the group with
    # its plain version (torch ops on the card): K1's forward output
    # feeds only the summed total. So the output K1 gave the forward is
    # recorded, and held against the plain version on the same arguments
    # and against realize's
    by, kw = apps["grad"]
    seen = []
    launch0 = gk.launch

    def recorded(plan, inputs, real_mins):
        res = launch0(plan, inputs, real_mins)
        seen.append((plan, [t.detach() for t in inputs], real_mins,
                     res.detach()))
        return res

    counts0()
    gk.launch = recorded
    try:
        g_card = ht.propagate_adjoints(by, **kw)
    finally:
        gk.launch = launch0
    n = counts()
    if len(seen) != 1:
        fail(f"propagate_adjoints: {len(seen)} K1 launches recorded")
    plan, ins, mins, fwd = seen[0]
    params = {id(p): p.get()
              for p in ht.pipeline.gather_graph([by]).params.values()}
    plain = gk.run_plain(plan, ins, mins, params, fwd.device)
    fwd_err = float((fwd.double() - plain.double()).abs().max())
    if not torch.allclose(fwd, plain, rtol=1e-5, atol=1e-6):
        fail(f"propagate_adjoints: K1's forward output differs from its "
             f"plain version (max abs err {fwd_err!r})")
    whole = by.realize(kw["sizes"]).to_numpy()
    fwd_same = np.array_equal(fwd.cpu().numpy(), whole)
    if not fwd_same:
        fail("propagate_adjoints: K1's forward output differs from "
             "realize's")
    g_cpu = ht.propagate_adjoints(by, device="cpu", **kw)
    errs = {}
    for k in g_cpu:
        a, b = np.asarray(g_card[k], np.float64), np.asarray(g_cpu[k],
                                                             np.float64)
        errs[k] = float((np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max())
        if not np.allclose(a, b, rtol=1e-5, atol=1e-6):
            fail(f"propagate_adjoints: {k} on the card differs from the CPU "
                 f"(max rel err {errs[k]!r})")
    if n["K1"] != 1 or n["rejects"]:
        fail(f"propagate_adjoints: counts {n}")
    ms = timer(lambda: ht.propagate_adjoints(by, **kw), 5)
    out["propagate_adjoints"] = {"counts": n, "max_rel_err": errs,
                                 "forward_k1_max_abs_err": fwd_err,
                                 "forward_equals_realize": fwd_same,
                                 "ms": ms}
    say(f"propagate_adjoints of a tiled float stencil 1536x2560 on the "
        f"card: counts {n}; K1's forward output against its plain version "
        f"max abs err {fwd_err!r} (rtol 1e-5), equal to realize's "
        f"{fwd_same}; the gradient (the plain version's recomputation) "
        f"against the CPU max rel err {errs} (rtol 1e-5); {ms:.4f} ms on "
        f"{card}")
    return out


def sharded_blur(m, width, height, tile, distribute):
    """blur's 3x3 box (apps/blur.py) centred, over a width x height u16
    ImageParam `input` with its edges repeated, so that the output has the
    input's size and a `distribute(y)` can shard both; blur_y tiled by
    `tile`, blur_x computed at its tiles (one K1 group). -> (pipeline,
    input)."""
    x, y = m.Var("x"), m.Var("y")
    xo, yo, xi, yi = m.Var("xo"), m.Var("yo"), m.Var("xi"), m.Var("yi")
    inp = m.ImageParam(m.UInt(16), 2, "input")
    cl = m.repeat_edge(inp)
    bx, by = m.Func("blur_x"), m.Func("blur_y")
    bx[x, y] = (cl[x - 1, y] + cl[x, y] + cl[x + 1, y]) / 3
    by[x, y] = (bx[x, y - 1] + bx[x, y] + bx[x, y + 1]) / 3
    by.tile(x, y, xo, yo, xi, yi, tile[0], tile[1]).vectorize(xi) \
      .parallel(yo)
    bx.compute_at(by, xo)
    if distribute:
        by.distribute(y, "shards")
    return m.Pipeline(by), inp


def distribute_phase(card, timer, ktimer, dev, width, height, tile, n,
                     hist_shape, bins, seed=0):
    """The sharded realize on a mesh of n shard slots of `dev` (one card):
    blur (`sharded_blur`) with distribute(y), each shard one K1 launch
    (counted), each launch held against its plain version, the whole bit
    for bit against the unsharded realize and numpy, both realizes timed
    in turns; the histogram with distribute(r.y), bit for bit against
    torch.bincount, with the route each shard's update took (K3 launches
    or a scatter); and `parallel.dryrun_multichip(n)`. `timer(fn, k)` is
    the median of k calls to completion from an idle card (L2 flushed),
    `ktimer` the same with the card held (device time). -> (the phase's
    numbers, the K1 row's numbers)."""
    import halide_tpu_torch as ht
    from halide_tpu_torch.ops import group_kernel as gk
    from halide_tpu_torch.ops import rowhist_kernel as rk
    from halide_tpu_torch.parallel import Mesh
    from halide_tpu_torch.parallel.dryrun import (dryrun_multichip,
                                                  sharded_histogram)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    mesh = Mesh([dev] * n, ("shards",))
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 1 << 14, (height, width), np.uint16)
    t_img = torch.from_numpy(img).to(dev)
    p_s, in_s = sharded_blur(ht, width, height, tile, True)
    p_1, in_1 = sharded_blur(ht, width, height, tile, False)
    in_s.set(t_img)
    in_1.set(t_img)
    sizes = [width, height]
    gk.launches = 0
    gk.rejects.clear()
    out, calls = capture(gk, "compute",
                         lambda: p_s.realize(sizes, mesh=mesh))
    sync()
    launched, rejects = gk.launches, dict(gk.rejects)
    want, calls_1 = capture(gk, "compute",
                            lambda: p_1.realize(sizes, device=dev))
    sync()
    say(f"blur {width}x{height} u16 tiled {tile[0]}x{tile[1]}, "
        f"distribute(y) over {n} shards of {dev}: K1 launches {launched}, "
        f"rejects {rejects}, group calls {len(calls)}")
    if rejects or len(calls) != n or (dev.type == "cuda"
                                      and launched != n):
        raise SystemExit(f"distribute: {n} shards launched K1 {launched} "
                         f"times in {len(calls)} group calls (rejects "
                         f"{rejects})")
    if not torch.equal(out.data, want.data):
        raise SystemExit("distribute: the sharded blur differs from the "
                         "unsharded realize")
    p = np.pad(img.astype(np.uint16), 1, mode="edge")
    bx = (p[:, :-2] + p[:, 1:-1] + p[:, 2:]) // 3
    golden = (bx[:-2] + bx[1:-1] + bx[2:]) // 3
    check_golden("sharded blur", out.to_numpy(), golden, 0, 0)
    err = k_ms = p_ms = 0.0
    nbytes = f32_ops = int_ops = 0
    shards = []
    for k, (args, _kw) in enumerate(calls):
        plan, inputs, rmins, params, _d = args
        got = gk.compute(plan, inputs, rmins, params, dev)
        sync()
        t0 = time.perf_counter()
        plain = gk.run_plain(plan, inputs, rmins, params, dev)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        e = (got.double() - plain.double()).abs().max().item()
        rec = plan.record()
        say(f"shard {k}: K1 over {list(plan.extents)} from mins {rmins}, "
            f"sub-tiles {rec['sub_tiles']}, grid {rec['grid']}, threads "
            f"{rec['threads']}: max abs err against its plain version "
            f"{e!r} (none allowed)")
        if e != 0:
            raise SystemExit(f"distribute: shard {k}'s K1 disagrees with "
                             "its plain version")
        t = ktimer(lambda: gk.compute(plan, inputs, rmins, params, dev),
                   30)
        err, k_ms, p_ms = max(err, e), k_ms + t, p_ms + ms
        nbytes += window_bytes(plan, inputs, rmins) \
            + int(np.prod(plan.extents)) * gk.itemsize(plan.out_type)
        f, i = count_ops(plan)
        f32_ops, int_ops = f32_ops + f, int_ops + i
        shards.append({"extents": list(plan.extents), "mins": rmins,
                       "sub_tiles": rec["sub_tiles"], "grid": rec["grid"],
                       "threads": rec["threads"], "ms": t})
    # the unsharded realize's one K1 launch, for the shards' sum
    (plan1, inputs1, rmins1, params1, _d), _kw = calls_1[0]
    k1_ms = ktimer(lambda: gk.compute(plan1, inputs1, rmins1, params1, dev),
                   30)
    # the two realizes in turns: unsharded, sharded, sharded, unsharded
    r1 = [timer(lambda: p_1.realize(sizes, device=dev), 10)]
    rs = [timer(lambda: p_s.realize(sizes, mesh=mesh), 10)
          for _ in range(2)]
    r1.append(timer(lambda: p_1.realize(sizes, device=dev), 10))
    say(f"blur on {card}: sharded realize {rs} ms, unsharded {r1} ms (in "
        f"turns u, s, s, u); K1 over the {n} shards {k_ms:.4f} ms, the "
        f"unsharded realize's one launch {k1_ms:.4f} ms (device)")

    # the sharded histogram
    H, W = hist_shape
    himg = rng.integers(0, bins, (H, W)).astype(np.int32)
    t_h = torch.from_numpy(himg).to(dev)
    ph = sharded_histogram(t_h, bins)
    gk.launches = rk.launches = 0
    hout = ph.realize([bins], mesh=mesh)
    sync()
    k3 = rk.launches
    route = {0: "scatter (scatter_add_ into int64 bins)",
             n: "K3 (one row histogram a shard)"}.get(k3)
    want_h = torch.bincount(t_h.flatten(), minlength=bins).to(torch.int32)
    say(f"histogram {W}x{H} int32, {bins} bins, distribute(r.y) over {n} "
        f"shards: K3 launches {k3}, K1 {gk.launches}: each shard's update "
        f"by {route}")
    if route is None or gk.launches:
        raise SystemExit(f"distribute: the histogram's shards launched K3 "
                         f"{k3} times and K1 {gk.launches}")
    if not torch.equal(hout.data.to(torch.int32), want_h):
        raise SystemExit("distribute: the sharded histogram differs from "
                         "torch.bincount")
    ph1 = sharded_histogram(t_h, bins)    # realized without a mesh
    h1 = [timer(lambda: ph1.realize([bins], device=dev), 10)]
    hs = [timer(lambda: ph.realize([bins], mesh=mesh), 10)
          for _ in range(2)]
    h1.append(timer(lambda: ph1.realize([bins], device=dev), 10))
    lib = timer(lambda: torch.bincount(t_h.flatten(), minlength=bins), 10)
    say(f"histogram on {card}: sharded realize {hs} ms, unsharded {h1} ms "
        f"(in turns), torch.bincount {lib:.4f} ms (to completion)")

    t0 = time.perf_counter()
    dry = dryrun_multichip(n, dev)
    sync()
    say(f"dryrun_multichip({n}, {str(dev)!r}): {dry} "
        f"({time.perf_counter() - t0:.1f} s)")
    summary = {"blur": {"shape": [height, width], "tile": list(tile),
                        "shards": n, "k1_launches": launched,
                        "sharded_realize_ms": rs,
                        "unsharded_realize_ms": r1, "per_shard": shards,
                        "unsharded_k1_ms": k1_ms},
               "hist": {"shape": [H, W], "bins": bins, "k3_launches": k3,
                        "route": route, "sharded_realize_ms": hs,
                        "unsharded_realize_ms": h1, "bincount_ms": lib},
               "dryrun": dry}
    row = dict(launches=launched, err=err, k_ms=k_ms, p_ms=p_ms,
               nbytes=nbytes, ops=(f32_ops, int_ops),
               realize_ms=statistics.median(rs),
               unsharded_realize_ms=statistics.median(r1),
               unsharded_k1_ms=k1_ms, shards=shards)
    return summary, row


def resnet_phase(card, timer, ktimer, dev, **kw):
    """resnet_50 (models/resnet50.py through apps/resnet_50.py; `kw` its
    build arguments, the canonical network by default) on `dev`: the first
    (planning) realize and the cached one timed apart on the host clock,
    the output against the numpy golden at the app's tolerance, each
    update's lowering (every conv2d the convolution path, fc the einsum
    path; none unrolled or dense), the realize (`timer`) and its TFLOP/s
    from `App.flops`, the device time of its convolution and einsum calls
    timed alone (`ktimer`, at full precision as the port runs them), and
    the realize's breakdown by device time. -> the phase's numbers."""
    from halide_tpu_torch import eval_torch
    from halide_tpu_torch.apps import get as app_get
    from halide_tpu_torch.ops import group_kernel as gk

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    app = app_get("resnet_50")(**kw)
    data = app.make_inputs(0)
    app.bind(data, dev)
    setup_s = time.perf_counter() - t0
    gk.launches = 0
    t0 = time.perf_counter()
    app.realize(dev)
    sync()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    app.realize(dev)
    sync()
    cached_s = time.perf_counter() - t0
    real = app.realize
    app.realize = lambda device=None: real(dev)
    row = reduction_app(app, data, f"resnet_50 {kw or 'canonical'}")
    paths = row["paths"]
    say("resnet_50: each update's lowering: " + ", ".join(
        f"{k} {v}" for k, v in paths.items()))
    bad = {k: v for k, v in paths.items()
           if v != ("einsum" if k == "fc" else "conv")}
    if bad:
        raise SystemExit(f"resnet_50: layers off the contraction paths: "
                         f"{bad}")
    # the logits (fc's output), held normwise: the softmax of the random
    # network is one-hot to within its atol, so only the logits can tell
    # f32 from TF32. The limit lies between the f32 reading and that of a
    # TF32 control run of the same network (HT_PRECISION=default, TF32
    # allowed), which must exceed it: the check is shown to separate them
    # in this run
    from halide_tpu_torch import Pipeline
    from halide_tpu_torch.pipeline import gather_graph
    fc = next(f for f in gather_graph(app.pipeline.outputs).funcs
              if f.name == "fc")
    lg_ref = app.logits_reference(**data)
    p_fc = Pipeline(fc)

    def logits_err():
        lg = p_fc.realize(app.output_sizes, device=dev).to_numpy()
        return float(np.abs(lg - lg_ref).max() / np.abs(lg_ref).max())

    lg_err = logits_err()
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (os.environ.get("HT_PRECISION"), mm.allow_tf32, dnn.allow_tf32)
    os.environ["HT_PRECISION"] = "default"
    mm.allow_tf32 = dnn.allow_tf32 = True
    try:
        tf32_err = logits_err()
    finally:
        if saved[0] is None:
            os.environ.pop("HT_PRECISION", None)
        else:
            os.environ["HT_PRECISION"] = saved[0]
        mm.allow_tf32, dnn.allow_tf32 = saved[1:]
    say(f"resnet_50 logits: max |got - numpy| / max |numpy| {lg_err!r} "
        f"(allowed {LOGITS_RTOL}); the TF32 control run's {tf32_err!r} "
        f"(must exceed it); largest |logit| "
        f"{float(np.abs(lg_ref).max())!r}")
    if not lg_err <= LOGITS_RTOL:
        raise SystemExit(f"resnet_50: logits off the numpy golden by "
                         f"{lg_err}")
    if dev.type == "cuda" and not tf32_err > LOGITS_RTOL:
        raise SystemExit(f"resnet_50: the TF32 control run's logits "
                         f"({tf32_err}) pass the limit {LOGITS_RTOL}")
    r_ms = timer(app.realize, 10)
    with eval_torch.contract_precision():
        conv_ms = sum(ktimer(
            lambda a=a, k=k: torch.nn.functional.conv2d(*a, **k), 10)
            for a, k in row["convs"])
        einsum_ms = sum(ktimer(lambda a=a, k=k: torch.einsum(*a, **k), 10)
                        for a, k in row["einsums"])
    out = {"setup_s": setup_s, "first_realize_s": first_s,
           "cached_realize_s": cached_s, "logits_rel_err": lg_err,
           "logits_rel_err_tf32_control": tf32_err,
           "realize_ms": r_ms,
           "gflop": app.flops / 1e9,
           "realize_tflops": app.flops / r_ms / 1e9,
           "convs": len(row["convs"]), "conv_ms": conv_ms,
           "einsums": len(row["einsums"]), "einsum_ms": einsum_ms,
           "library_tflops": app.flops / (conv_ms + einsum_ms) / 1e9,
           "inline": row["inline"], "k1_launches": gk.launches}
    say(f"resnet_50 on {card}: " + json.dumps(out))
    if dev.type == "cuda":
        breakdown(app)
    return out, app


def stage_phase(app, note, flush):
    """The stage kernel on `app`'s main path (bound on the card): its count
    (`stage_kernel.fused`), zeroed just before an eager realize (the plan
    cache cleared, so that no CUDA graph replays it), must equal the
    stages it takes; then every whole-array stage of that realize is made
    again (`stage_kernel.stage_calls`), and each taken stage's kernel is
    launched on the arrays it read there and held against eval_torch's
    evaluation of the same stage on the same arrays (`_evaluate_func`
    under `stage_kernel.declining`): the same shape, strides and dtype,
    integers bit for bit, floats within 1e-5 of the stage's largest value.
    Both are timed (the kernel's device time after an L2 flush, median of
    20; the plain version's, median of 3) beside the kernels' bytes bound
    (each input read once, the output written once). -> its row of the
    kernel table."""
    from halide_tpu_torch.eval_torch import Ctx
    from halide_tpu_torch.ops import stage_kernel as stk
    from halide_tpu_torch.pipeline import _evaluate_func, last_realize
    dev = torch.device("cuda")
    app.pipeline._plan_cache.clear()
    stk.fused = 0
    app.realize()
    torch.cuda.synchronize()
    fused = stk.fused
    params = last_realize(app.pipeline, dev)[4]
    calls = stk.stage_calls(app.pipeline, dev)
    taken = [c for c in calls if not isinstance(c[3], str)]
    if fused != len(taken):
        declined = [c[3] for c in calls if c not in taken]
        raise SystemExit(f"{app.name}: the realize took {fused} stages to "
                         f"the stage kernel, its stages {len(taken)} "
                         f"(declined: {declined})")
    k_ms = p_ms = 0.0
    nbytes, err, rel = 0, 0.0, 0.0
    for f, box, before, spec, _out in taken:
        arrays = [before[tid].arrays[vi] for tid, vi in spec.slots]
        ctx0 = Ctx(0, {}, {}, before, params, dev)

        def plain():
            with stk.declining("the stage kernel's plain version"):
                return _evaluate_func(f, box, ctx0).arrays[0]

        def kernel():
            return stk.launch(spec, arrays, dev)

        got, want = kernel(), plain()
        if (got.shape, got.stride(), got.dtype) != \
                (want.shape, want.stride(), want.dtype):
            raise SystemExit(
                f"{app.name} {f.name}: kernel {tuple(got.shape)} "
                f"{got.stride()} {got.dtype}, plain version "
                f"{tuple(want.shape)} {want.stride()} {want.dtype}")
        if want.is_floating_point():
            e = float((got.double() - want.double()).abs().max())
            scale = max(float(want.double().abs().max()), 1e-30)
            if not e <= 1e-5 * scale:
                raise SystemExit(f"{app.name} {f.name}: the kernel is off "
                                 f"its plain version by {e} (largest "
                                 f"value {scale})")
            err, rel = max(err, e), max(rel, e / scale)
        elif not torch.equal(got, want):
            raise SystemExit(f"{app.name} {f.name}: the kernel differs "
                             "from its plain version")
        k_ms += event_ms(kernel, 20, flush, hold=True)
        p_ms += event_ms(plain, 3, flush)
        nbytes += spec.bytes
    row = kernel_row(
        f"stage kernel ({note}, {len(taken)} stages)",
        "halide_tpu_torch/ops/stage_kernel.py",
        "halide_tpu_torch/eval_torch.py (a whole-array stage, one torch "
        "kernel per expression node)", fused, err, k_ms, p_ms, nbytes,
        (0, 0), None, max_rel_err=rel,
        library_note="no single PyTorch call computes a fused stage")
    say(f"{note}: {fused} stages through the stage kernel; kernels "
        f"{k_ms:.4f} ms (device, summed), plain versions {p_ms:.2f} ms, "
        f"bound {row['bound_ms']:.4f} ms ({nbytes} bytes); largest float "
        f"error {err!r} ({rel!r} of the stage's largest value)")
    return row


def tutorials_phase(dev):
    """Every lesson of tutorials_torch/ run with main(dev), loaded by path
    under a name of its own. -> {lesson: seconds}."""
    import importlib.util
    import pathlib
    d = pathlib.Path(__file__).resolve().parent / "tutorials_torch"
    secs = {}
    for p in sorted(d.glob("lesson_*.py")):
        spec = importlib.util.spec_from_file_location(
            f"halide_tpu_torch_tutorial_{p.stem}", p)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        t0 = time.perf_counter()
        mod.main(str(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs[p.stem] = round(time.perf_counter() - t0, 3)
    if len(secs) != 30:
        raise SystemExit(f"tutorials: {len(secs)} lessons, not 30")
    return secs


def kernel_row(name, source, replaces, launches, err, k_ms, p_ms, nbytes,
               ops, lib_ms, **extra):
    """One row of the kernel table. `ops` is (f32, integer) operations:
    their least time is the larger of all of them issued at the f32 rate
    (one operation per lane and cycle, either type) and the integer ones
    on their own half-width lanes."""
    f32_ops, int_ops = ops
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = max((f32_ops + int_ops) / F32_OPS_PER_S,
                int_ops / INT_OPS_PER_S) * 1e3
    return dict({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": max(b_bytes, b_ops),
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "library_ms": lib_ms, "f32_ops": f32_ops, "int_ops": int_ops},
        **extra)


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
    import halide_tpu_torch as ht
    from halide_tpu_torch.apps import (TILED_PRODUCERS, App,
                                       bilateral_grid, blur, bgu,
                                       camera_pipe, compositing, harris,
                                       hist, iir_blur, interpolate,
                                       linear_blur, local_laplacian,
                                       nl_means, stencil_chain,
                                       tile_producers, unsharp, wavelet)
    from halide_tpu_torch.apps import get as app_get
    from halide_tpu_torch.ops import build
    from halide_tpu_torch.ops import group_kernel as gk
    from halide_tpu_torch.ops import rowhist_kernel as rk
    from halide_tpu_torch.ops import scan_kernel as sk
    from halide_tpu_torch.ops import stage_kernel as stk

    phase("plan")
    app_b = blur.build(2560, 1536, tile=(256, 128))
    app_l = linear_blur.build(1536, 2560)
    app_p = interpolate.build(1536, 2560)
    app_ll = local_laplacian.build(1536, 2560)
    app_s = stencil_chain.build(1536, 2560, 32, kernel=True)
    app_sl = stencil_chain.build(1536, 2560, 32, slide=512)
    app_c = camera_pipe.build(2560, 1920, kernel=True, tile=(2560, 128))
    app_c64 = camera_pipe.build(2560, 1920, kernel=True, tile=(256, 64))
    pipe_8, sizes_8, golden_8 = div8_group(1536, 2560)
    app_8 = App("div8", pipe_8, [], lambda seed=0: {},
                lambda: golden_8, sizes_8, tolerance=1e-6, atol=1e-6)
    app_un = unsharp.build(1536, 2560)
    app_hr = harris.build(1536, 2560)
    app_wv = wavelet.build(1536, 2560)
    # the box sums' group (tile 256x64, the JAX app's schedule)
    app_nl = nl_means.build(1536, 2560)
    # the last image apps' groups, at the JAX apps' schedules: compositing
    # tiled 256x128 (blended, a 4-valued member with a masked 5x5 update),
    # bilateral_grid's and bgu's slices tiled 512x256
    app_co = compositing.build(1536, 2560)
    app_bg = bilateral_grid.build(1536, 2560)
    app_bgu = bgu.build(1536, 2560)
    app_unt = unsharp.build(1536, 2560)
    app_hrt = harris.build(1536, 2560)
    # slice3_surface's pipelines: unsharp under a specialization ladder
    # (planned on its tiled branch), camera_pipe with a memoized tone
    # curve, blur over an extern stage, blur to be traced and blur with a
    # dumped producer
    app_sp, p_sp = spec_unsharp(1536, 2560, (256, 128))
    app_cm = memo_camera_pipe(2560, 1920, (256, 64))
    pipe_e, raw_e, golden_e = extern_blur(2560, 1536, (256, 128))
    data_e = blur.build(2560, 1536).make_inputs(0)["input"]
    app_e = App("extern_blur", pipe_e, [raw_e], lambda seed=0: {},
                golden_e, [2558, 1534])
    app_tr = blur.build(2560, 1536, tile=(256, 128))
    app_dbg = blur.build(2560, 1536)
    for app in (app_unt, app_hrt):
        tile_producers(ht, app.pipeline, (256, 128),
                       TILED_PRODUCERS[app.name])
    apps_in = {}                  # the intrinsics group's App, per lanes
    for dt in ("int32", "uint16", "uint32"):
        a_in, b_in = intrinsic_inputs(dt, 1536, 2560)
        whole = intrinsic_group(ht, dt, a_in, b_in).realize(
            [1536, 2560]).to_numpy()
        apps_in[dt] = App(f"intrinsics_{dt}", intrinsic_group(
            ht, dt, a_in, b_in, tile=(256, 128)), [], lambda seed=0: {},
            lambda whole=whole: whole, [1536, 2560])
    apps_h = {}                   # the Let group's App, per 16-bit float
    a_h = np.random.default_rng(0).integers(8, 32, (2560, 1536)) / 16
    for dt in ("float16", "bfloat16"):
        t_h = torch.from_numpy(a_h).to(getattr(torch, dt)).cuda()
        whole = let_group(ht, dt, t_h).realize([1536, 2560]).to_numpy()
        apps_h[dt] = App(f"let_{dt}", let_group(ht, dt, t_h, (256, 128)), [],
                         lambda seed=0: {}, lambda whole=whole: whole,
                         [1536, 2560])
    data = {}
    apps = [app_b, app_l, app_p, app_ll, app_s, app_sl, app_c, app_c64,
            app_un, app_hr, app_wv, app_unt, app_hrt, app_nl, app_co, app_bg,
            app_bgu, app_sp, app_cm, app_tr, app_dbg]
    for app in apps:
        data[id(app)] = app.make_inputs(0)
        app.bind(data[id(app)])            # onto the card
    raw_e.set(torch.from_numpy(data_e).cuda())
    app_rb, _text = deserialized(app_c64)  # camera_pipe read back
    app_rb.bind(data[id(app_c64)])
    p_sp.set(1)                            # the tiled branch
    # slice3_tools' pipelines, planned here so that their sources build with
    # the rest: blur, unsharp, harris and camera_pipe with their producers
    # unscheduled (the reference's auto-scheduled variants; camera_pipe
    # keeps its demosaic's roots, as its kernel branch does),
    # autoscheduled by both searches (beside their manual schedules:
    # blur's and camera_pipe's kernel branch tiles, unsharp and harris
    # tiled 256x128), blur for Anderson2021 and at tilesearch's
    # three tiles, fitcost's chains in K1 and the stencil
    # propagate_adjoints differentiates
    from halide_tpu_torch.tools import fitcost
    auto = {}
    for nm, build_a, manual in (
            ("blur", lambda: blur.build(2560, 1536), app_b),
            ("unsharp", lambda: unschedule(unsharp.build(1536, 2560)),
             app_unt),
            ("harris", lambda: unschedule(harris.build(1536, 2560)),
             app_hrt),
            ("camera_pipe", lambda: camera_pipe.build(
                2560, 1920, roots="deinterleaved,g_r,g_b"), app_c64)):
        autos = {sc: auto_app(build_a, sc)
                 for sc in ("Mullapudi2016", "Adams2019")}
        for a, _rep in autos.values():
            a.bind(data[id(manual)])
        auto[nm] = (manual, data[id(manual)], autos)
    app_an = blur.build(2560, 1536)        # scheduled by Anderson2021
    app_an.pipeline.outputs[0].set_estimates([(0, 2558), (0, 1534)])
    app_an.bind(data[id(app_b)])
    tiles = [(256, 128), (128, 64), (2560, 128)]
    app_ts = []
    for t in tiles:
        a = blur.build(2560, 1536)
        a.pipeline.outputs[0].set_estimates([(0, 2558), (0, 1534)])
        a.pipeline.apply_autoscheduler(params={"tile": t})
        a.bind(data[id(app_b)])
        app_ts.append(a)
    chain_in = torch.zeros((4096, 4096), device="cuda")
    app_ch = [App(f"chain{k}", fitcost.chain_pipeline(
        ht, k, chain_in, (256, 128)), [], lambda seed=0: {}, None,
        [4096, 4096]) for k in (16, 128)]
    grad_by, grad_kw = grad_stencil(ht, 1536, 2560, (256, 128))
    app_gr = App("grad", ht.Pipeline(grad_by), [], lambda seed=0: {}, None,
                 [1536, 2560])
    # the distribute phase's blur, planned in its shards' coordinates: one
    # K1 source serves every shard (the phase builds the same pipeline
    # again, whose source hashes to the same build)
    from halide_tpu_torch.parallel import Mesh
    mesh_ds = Mesh(["cuda:0"] * DIST_SHARDS, ("shards",))
    p_ds, in_ds = sharded_blur(ht, 2560, 1536, (256, 128), True)
    in_ds.set(torch.from_numpy(np.zeros((1536, 2560), np.uint16)).cuda())
    app_ds = App("blur_sharded", p_ds, [], lambda seed=0: {}, None,
                 [2560, 1536])
    app_ds.realize = lambda device=None: p_ds.realize([2560, 1536],
                                                      mesh=mesh_ds)
    plans, stage_specs = plan_groups(
        [app_b, app_l, app_p, app_ll, app_s, app_sl, app_c, app_c64, app_8,
         app_unt, app_hrt, app_nl, app_co, app_bg, app_bgu, app_sp, app_cm,
         app_e, app_tr, app_rb]
        + list(apps_in.values()) + list(apps_h.values())
        + [a for _m, _d, au in auto.values() for a, _r in au.values()]
        + app_ts + app_ch + [app_gr, app_ds])
    sources = {p.symbol: p for p in plans}
    stage_specs = list({s.key: s for s in stage_specs}.values())
    say(f"{len(plans)} group plans, {len(sources)} kernel sources; "
        f"{len(stage_specs)} stage kernel sources")

    phase("build")
    with ThreadPoolExecutor(8) as pool:
        jobs = [pool.submit(build.load_fixed, n)
                for n in ("scan_kernel", "rowhist_kernel")]
        # K3 with counting compiled out (1), and the loads too (2)
        k3_parts = {n: pool.submit(k3_build, [("ROWHIST_PART", n)])
                    for n in (1, 2)}
        jobs += [pool.submit(gk.build, p) for p in sources.values()]
        # the stage kernels in 8 translation units, built side by side
        jobs += [pool.submit(stk.build, stage_specs[k::8]) for k in range(8)
                 if stage_specs[k::8]]
        for f in jobs + list(k3_parts.values()):
            f.result()
        k3_parts = {n: f.result() for n, f in k3_parts.items()}
    for key, secs in build.builds:
        say(f"nvcc build {key}: {secs:.1f} s; ptxas: "
            f"{' | '.join(build.ptxas.get(key, []))}")

    phase("blur")
    res_b = run_app(app_b, data[id(app_b)],
                    "blur 2560x1536 u16, tile 256x128", 0)

    phase("linear_blur")
    res_l = run_app(app_l, data[id(app_l)], "linear_blur 1536x2560x3 f32, "
                    "tile 1536x256", 1e-4, walks=(True,))

    phase("interpolate")
    res_p = run_app(app_p, data[id(app_p)], "interpolate 1536x2560x4 f32, "
                    "10 levels, tile 256x64", 0.0, rtol=1e-5)

    phase("local_laplacian")
    res_ll = run_app(app_ll, data[id(app_ll)], "local_laplacian "
                     "1536x2560x3 u16, 8+8 levels, tile 256x64", 0.0,
                     frac=0.003, cap=2.0)

    phase("stencil_chain")
    golden_s = app_s.reference(**data[id(app_s)])
    res_s = run_app(app_s, data[id(app_s)], "stencil_chain 1536x2560 u16, "
                    "32 stencils, groups of 8 in 128-row bands", 0,
                    walks=(False, False, False, True), bands=2,
                    golden=golden_s)

    # the slide branch (the same input): tiles 512x128, each group's
    # stages stored at the row loop
    phase("stencil_chain_slide")
    res_sl = run_app(app_sl, data[id(app_sl)], "stencil_chain 1536x2560 "
                     "u16, 32 stencils, slide=512 (tiles 512x128, stages "
                     "store_at the row loop)", 0, walks=(False,) * 4,
                     bands=1, golden=golden_s)

    phase("let_half")
    res_h = {dt: run_app(app, {}, f"Let group, {dt}, 1536x2560, tile 256x128 "
                         "(golden: the untiled pipeline, whole-array)", 0)
             for dt, app in apps_h.items()}

    phase("camera_pipe")
    golden_c = app_c.reference(**data[id(app_c)])
    res_c = run_app(app_c, data[id(app_c)], "camera_pipe 2560x1920 u8, "
                    "tile 2560x128", 0, walks=(True,), bands=2,
                    golden=golden_c)
    res_c64 = run_app(app_c64, data[id(app_c64)], "camera_pipe 2560x1920 "
                      "u8, tile 256x64", 0, bands=2, golden=golden_c)

    phase("div8")
    res_8 = run_app(app_8, {}, "1536x2560 f32 tile reading (x / 8, y / 8)",
                    0.0, rtol=1e-6)

    phase("whole_array_apps")
    run_whole(app_un, data[id(app_un)], "unsharp 1536x2560x3 f32, default "
              "schedule")
    run_whole(app_hr, data[id(app_hr)], "harris 1536x2560x3 f32 in, "
              "1530x2554 out, default schedule (compute_with pair)")
    run_whole(app_wv, data[id(app_wv)], "wavelet 1536x2560 f32, default "
              "schedule")

    # exact: the kernel does the plain version's f32 operations in its
    # order (-fmad=false, IEEE division; unsharp's taps are expf of
    # constants on both sides), as the chip runs measured
    phase("unsharp_tiled")
    res_unt = run_app(app_unt, data[id(app_unt)], "unsharp 1536x2560x3 f32, "
                      "tile 256x128, gray and blur_y at the tiles", 0.0)

    phase("harris_tiled")
    res_hrt = run_app(app_hrt, data[id(app_hrt)], "harris 1536x2560x3 f32 "
                      "in, tile 256x128, gray, Ix and Iy at the tiles", 0.0)

    phase("intrinsics")
    res_in = {dt: run_app(app, {}, f"integer intrinsics, {dt} lanes, "
                          "1536x2560, tile 256x128 (golden: the untiled "
                          "pipeline, whole-array)", 0)
              for dt, app in apps_in.items()}
    a64, b64, f64 = (np.random.default_rng(s).integers(
        0, 2 ** 64 - 1, (2560, 1536), endpoint=True, dtype=np.uint64)
        for s in (1, 2, 3))
    a64[0, :5] = [0, 1, 2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1]
    b64[::7] = 0
    b64[1::11] = 1
    f64 = (f64 >> np.uint64(11)).astype(np.float64) * 4.0 - 2.0 ** 64
    f64[0, :5] = [np.nan, np.inf, -np.inf, 2.0 ** 63, 2.0 ** 64]
    pipe_64, golden_64 = u64_pipeline(ht, *(torch.from_numpy(v).cuda()
                                            for v in (a64, b64, f64)))
    got_64 = pipe_64.realize([1536, 2560, 15]).to_numpy()
    bad_64 = [c for c, (g, w) in enumerate(zip(got_64, golden_64(
        a64, b64, f64))) if not np.array_equal(g, w)]
    say(f"u64 pipeline 1536x2560x15 on the card against numpy: planes that "
        f"differ {bad_64} (none allowed)")
    if bad_64:
        raise SystemExit(f"u64: planes {bad_64} disagree with numpy")

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
    plan_h = dict(rk.last_plan)
    say(f"K3's plan at hist's lin: {plan_h}")
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
    # K3 beyond the main path: hist's lin at the first design's geometry,
    # the transposed layout, the offset and odd-width views, the contention
    # inputs and the cluster shape, each at the planned point and the first
    # design's geometry, against the plain version
    lins_k3 = dict(hist=lin_h, **k3_inputs(lin_h, K_h))
    plans_k3 = {}
    for n, lin in lins_k3.items():
        want = rk.rowhist_plain(lin, K_h, scale_h)
        for label, force in (("planned", None), ("first design's geometry",
                                                 rk.OLD_DESIGN)):
            got = rk.launch(lin, K_h, scale_h, plan=force)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"K3 at the {label} point on {n} disagrees "
                                 "with its plain version")
            if force is None:
                plans_k3[n] = dict(rk.last_plan)
        say(f"K3 on {n} {tuple(lin.shape)} stride {lin.stride()} base % 16 "
            f"= {lin.data_ptr() % 16}: planned {plans_k3[n]} and the first "
            "design's geometry equal the plain version (exact)")
    if plans_k3["offset"]["unit"] != 16 or plans_k3["odd_width"]["unit"] != 4:
        raise SystemExit(f"K3's offset view or odd width planned another "
                         f"unit: {plans_k3['offset']}, {plans_k3['odd_width']}")
    if plans_k3["cluster"]["cluster"] < 2:
        raise SystemExit(f"K3 planned no cluster at 64 x 262144: "
                         f"{plans_k3['cluster']}")

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

    def k1_row(name, replaces, app, res, **extra):
        """A K1 row: the kernel's device time summed over the main path's
        group calls (one launch each), its plain version's, the whole
        realize and the bound of those calls' bytes and operations."""
        calls, launches, err, p_ms = res
        k_ms, nbytes, f32_ops, int_ops, per = 0.0, 0, 0, 0, []
        for plan, inputs, rmins, params, realz in calls:
            t = event_ms(lambda: gk.launch(plan, inputs, rmins), 30, flush,
                         hold=True)
            k_ms += t
            nbytes += window_bytes(plan, inputs, rmins) \
                + int(np.prod(plan.extents)) * gk.itemsize(plan.out_type)
            f, i = count_ops(plan, realz, params)
            f32_ops, int_ops = f32_ops + f, int_ops + i
            rec = plan.record()
            per.append({k: rec[k] for k in ("func", "tile", "sub_tile",
                                            "grid", "smem_bytes", "threads",
                                            "min_blocks", "band_walk")}
                       | {"ms": t})
        r_ms = event_ms(app.realize, 20, flush)
        row = kernel_row(
            name, "halide_tpu_torch/ops/group_kernel.py", replaces,
            launches, err, k_ms, p_ms, nbytes, (f32_ops, int_ops), None,
            realize_ms=r_ms,
            groups=per,
            library_note="no single PyTorch call computes a fused group",
            **extra)
        kernels.append(row)
        say(f"{name} on {card}: kernel {k_ms:.4f} ms (device, {launches} "
            f"launches), plain version {p_ms:.1f} ms (one call each), whole "
            f"realize {r_ms:.4f} ms (host, to completion); bound "
            f"{row['bound_ms'] * 1e3:.2f} us by {row['bound_by']} ({nbytes} "
            f"bytes, {f32_ops} f32 and {int_ops} integer operations); groups "
            f"{per}")
        return row

    k1 = "halide_tpu/ops/pallas_group.py:696"
    k1_row(f"K1 stencil group ({app_b.name})", k1, app_b, res_b)
    k1_row(f"K1 stencil group ({app_l.name})", k1, app_l, res_l)
    k1_row(f"K1 stencil group ({app_p.name})", k1, app_p, res_p)
    k1_row(f"K1 stencil group ({app_ll.name})", k1, app_ll, res_ll)
    some = "the output rows of the first and last 2 bands of each launch"
    k1_row(f"K1 stencil group ({app_s.name}, 4 groups)", k1, app_s, res_s,
           plain_on=some)
    k1_row(f"K1 stencil group ({app_sl.name} slide=512, 4 groups)", k1,
           app_sl, res_sl, plain_on="the output rows of the first and last "
                                    "band of each launch")
    k1_row(f"K1 stencil group ({app_c.name}, tile 2560x128)", k1, app_c,
           res_c, plain_on=some)
    k1_row(f"K1 stencil group ({app_c64.name}, tile 256x64)", k1, app_c64,
           res_c64, plain_on=some)
    k1_row("P4 8-fold repeat as K1's d = 8 window (1536x2560 f32)",
           "halide_tpu/eval_jnp.py:890", app_8, res_8)
    k1_row(f"K1 stencil group ({app_unt.name}, tile 256x128)", k1, app_unt,
           res_unt)
    k1_row(f"K1 stencil group ({app_hrt.name}, tile 256x128)", k1, app_hrt,
           res_hrt)
    for dt, app in apps_in.items():
        k1_row(f"K1 stencil group (integer intrinsics, {dt} lanes)", k1, app,
               res_in[dt])
    for dt, app in apps_h.items():
        k1_row(f"K1 stencil group (Let group, {dt})", k1, app, res_h[dt])
    # the default schedules (whole-array) beside the reference Halide's GPU
    # column (BASELINE.md, NVIDIA RTX 2060)
    for app, ref in ((app_un, "0.4-0.5 ms"), (app_hr, "0.253 ms"),
                     (app_wv, "none published")):
        r_ms = event_ms(app.realize, 20, flush)
        say(f"{app.name} default schedule on {card}: whole realize "
            f"{r_ms:.4f} ms (host, to completion); the reference Halide's "
            f"GPU time {ref}")

    def scan_times(calls):
        """Summed over the calls: kernel and plain-version ms, bytes, f32
        operations (a multiply and an add per element)."""
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
    # K2a's segment length: the same four calls at 16 and 32 elements a
    # thread (segments of 128 and 256), in turns (16, 32, 32, 16)
    by_sub = {16: [], 32: []}
    for sub in (16, 32, 32, 16):
        t_sub = 0.0
        for (out, b, init, axis, bwd), kw in calls_i:
            o = torch.empty_like(out)
            t_sub += event_ms(lambda: sk.launch(o, b, init, axis, bwd,
                                                sub=sub, **kw), 30, flush,
                              hold=True)
        by_sub[sub].append(t_sub)
    say(f"K2a x4 at 16 and 32 elements a thread: {by_sub} ms (device; "
        "16, 32, 32, 16; planned: 32 along the contiguous axis, 16 along a "
        "strided one)")
    kernels.append(kernel_row(
        "K2a scan, constant coefficient (iir_blur, per realize)",
        "halide_tpu_torch/ops/csrc/scan_kernel.cu",
        "halide_tpu/ops/pallas_scan.py:39", n_i["const"], err_i, k_ms, p_ms,
        nbytes, (ops, 0), None, realize_ms=r_ms, ms_by_sub=by_sub,
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
        p_ms, nbytes, (ops, 0), None, realize_ms=r_ms,
        library_note="no single torch call computes a recurrence with "
                     "a != 1 (cumsum is a = 1)"))
    say(f"scan_general on {card}: K2b {k_ms:.4f} ms (device), plain "
        f"{p_ms:.2f} ms, whole realize {r_ms:.4f} ms")

    R, P = lin_h.shape

    def k3_ms(lin, force, lib=None):
        if lib is None:
            return event_ms(lambda: rk.launch(lin, K_h, scale_h, plan=force),
                            30, flush, hold=True)
        return event_ms(lambda: k3_call(lib, lin, K_h, scale_h, force), 30,
                        flush, hold=True)
    # each K3 input at the planned point and the first design's geometry,
    # in turns (planned, first, first, planned); the cluster shape also
    # with the planned geometry on one block a row; hist's lin also through
    # the builds with counting compiled out (loads only) and with the loads
    # out too (launch, zeroing, merge and write only)
    k3_by_input = {}
    first = "first_design_geometry"
    for n, lin in lins_k3.items():
        plan = plans_k3[n]
        t = {"planned": [], first: []}
        for which in ("planned", first, first, "planned"):
            t[which].append(k3_ms(lin, plan if which == "planned"
                                  else rk.OLD_DESIGN))
        if n == "cluster":
            t["no_cluster"] = [k3_ms(lin, dict(plan, cluster=1))]
        if n == "hist":
            t["load_only"] = [k3_ms(lin, plan, k3_parts[1])]
            t["merge_only"] = [k3_ms(lin, plan, k3_parts[2])]
            t[first + "_load_only"] = [k3_ms(lin, rk.OLD_DESIGN,
                                             k3_parts[1])]
        nb = (lin.numel() + lin.shape[0] * K_h) * 4
        k3_by_input[n] = dict(t, shape=list(lin.shape),
                              stride=list(lin.stride()),
                              bound_ms=nb / HBM_BYTES_PER_S * 1e3,
                              plan={f: plan[f] for f in rk.PLAN_FIELDS + (
                                  "grid", "resident", "smem_bytes")})
        say(f"K3 on {n} on {card}: {t} ms (device); bound "
            f"{nb / HBM_BYTES_PER_S * 1e6:.2f} us; plan "
            f"{k3_by_input[n]['plan']}")
    k_ms = statistics.median(k3_by_input["hist"]["planned"])
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
        k_ms, p_ms, nbytes, (0, 2 * lin_h.numel()), lib_ms,
        realize_ms=r_ms, plan=k3_by_input["hist"]["plan"],
        ms_first_design_geometry=statistics.median(
            k3_by_input["hist"][first]),
        by_input=k3_by_input))
    say(f"hist on {card}: K3 {k_ms:.4f} ms (device), plain {p_ms:.2f} ms, "
        f"bincount {lib_ms:.4f} ms (to completion), whole realize "
        f"{r_ms:.4f} ms; bound {nbytes / HBM_BYTES_PER_S * 1e6:.2f} us "
        f"({nbytes} bytes)")

    phase("breakdown")
    for app in (app_b, app_l, app_p, app_ll, app_s, app_sl, app_c, app_c64,
                app_8, app_i, app_h, app_un, app_hr, app_wv, app_unt,
                app_hrt):
        breakdown(app)

    # inline reductions and contractions: nl_means's box sums through K1
    # (its plain version on the first and last band's sub-tile rows), then
    # whole-array apps of inline reductions and contraction updates
    phase("reductions")
    from halide_tpu_torch import eval_torch
    res_nl = run_app(app_nl, data[id(app_nl)], "nl_means 1536x2560x3 f32, "
                     "patch 7, search 7, tile 256x64 (d, blur_d_y, blur_d: "
                     "inline sums)", 0.0, rtol=1e-6, bands=1)
    row_nl = k1_row("K1 stencil group (nl_means box sums, inline Reduce)",
                    "halide_tpu/ops/pallas_group.py:696", app_nl, res_nl)
    say(f"nl_means: plan {res_nl[0][0][0].record()}")
    breakdown(app_nl)
    red_apps = [
        ("gaussian_blur", dict(width=1536, height=2560), None),
        ("conv_layer", {}, 1.87),
        ("depthwise_separable_conv", {}, 0.066),
        ("sgemm", dict(M=2048, N=2048, K=2048), None),
        ("hgemm", dict(M=2048, N=2048, K=2048), None),
        ("dgemm", dict(M=512, N=512, K=512), None),
        ("sasum", dict(N=1 << 22), None),
        ("max_filter", dict(width=1536, height=2560, radius=26), 11.8),
        ("fft", dict(width=256, height=256), None),
    ]
    red_rows = []
    for name_r, kw, ref_ms in red_apps:
        app = app_get(name_r)(**kw)
        d = app.make_inputs(0)
        app.bind(d)
        row = reduction_app(app, d, f"{name_r} {kw or 'defaults'}", ref_ms)
        row["realize_ms"] = event_ms(app.realize, 10, flush)
        with eval_torch.contract_precision():
            row["conv_ms"] = sum(event_ms(
                lambda a=a, k=k: torch.nn.functional.conv2d(*a, **k), 20,
                flush, hold=True) for a, k in row["convs"])
            row["einsum_ms"] = sum(event_ms(
                lambda a=a, k=k: torch.einsum(*a, **k), 20, flush,
                hold=True) for a, k in row["einsums"])
        row["convs"], row["einsums"] = len(row["convs"]), len(row["einsums"])
        # a contraction app's useful operations over the library calls'
        # device time and over the realize
        lib_ms = row["conv_ms"] + row["einsum_ms"]
        row["gflop"] = app.flops and app.flops / 1e9
        row["library_tflops"] = app.flops and app.flops / lib_ms / 1e9
        row["realize_tflops"] = app.flops and (app.flops / row["realize_ms"]
                                               / 1e9)
        red_rows.append(row)
        say(f"{name_r} on {card}: realize {row['realize_ms']:.4f} ms "
            f"(reference Halide's GPU: {ref_ms} ms); library calls: "
            f"{row['convs']} convolutions {row['conv_ms']:.4f} ms, "
            f"{row['einsums']} einsums {row['einsum_ms']:.4f} ms (device); "
            f"{row['gflop']} GFLOP: {row['library_tflops']} TFLOP/s over "
            f"the library calls, {row['realize_tflops']} over the realize")
    a_am = np.random.default_rng(0).integers(0, 3, (2560, 1536)).astype(
        np.int32)
    pipe_am, sizes_am, golden_am = argmax_pipeline(ht, a_am)
    got_am = [b.to_numpy() for b in pipe_am.realize(sizes_am)]
    bad_am = [k for k, (g, w) in enumerate(zip(got_am, golden_am))
              if not np.array_equal(g, w)]
    say(f"integer argmax over a 5x4 RDom with ties, {sizes_am}, against "
        f"numpy: outputs that differ {bad_am} (none allowed); ties in "
        f"{float((a_am == 2).mean())!r} of the points' values")
    if bad_am:
        raise SystemExit(f"argmax: outputs {bad_am} disagree with numpy")
    say("realizes: " + json.dumps(
        [{k: r[k] for k in ("app", "realize_ms", "reference_gpu_ms",
                            "paths", "inline", "convs", "conv_ms",
                            "einsums", "einsum_ms", "gflop",
                            "library_tflops", "realize_tflops")}
         for r in red_rows]
        + [{"app": "nl_means", "realize_ms": row_nl["realize_ms"],
            "reference_gpu_ms": 22.0}]))

    # the last image apps: compositing, bilateral_grid and bgu through K1
    # (each launch against its plain version on the first and the last
    # band), resize and lens_blur whole-array
    phase("slice2_apps")
    slice2_apps(app_co, app_bg, app_bgu, data, card, k1_row, flush)

    # the surface around realize: specialize, serialize, trace, profile,
    # memoize, an extern stage and debug_to_file
    phase("slice3_surface")
    app_ib, _t = deserialized(app_i)
    app_hb, _t = deserialized(app_h)
    surface = slice3_surface(
        card, lambda fn, n: event_ms(fn, n, flush), torch.device("cuda"),
        {"blur": [2558, 1534]},
        {"spec": (app_sp, p_sp), "spec_data": data[id(app_sp)],
         "spec_tiled": app_unt, "spec_default": app_un,
         "serial": [(app_c64, app_rb, data[id(app_c64)], "K1"),
                    (app_i, app_ib, data_i, "K2a"),
                    (app_h, app_hb, data_h, "K3")],
         "trace": app_tr, "profile": app_ll, "memo": app_cm,
         "memo_same": app_c64,
         "extern": (pipe_e, raw_e, golden_e, data_e),
         "debug": (app_dbg, data[id(app_dbg)])})
    say(f"slice3_surface on {card}: " + json.dumps(surface))

    # the autoschedulers, fitcost, tilesearch, the generator's exported
    # programs, rungen and propagate_adjoints
    phase("slice3_tools")
    tools = slice3_tools(
        card, lambda fn, n: event_ms(fn, n, flush), torch.device("cuda"),
        {"auto": auto, "anderson": (app_an, data[id(app_b)]),
         "tiles": tiles,
         "object": [("blur", app_b, ["width=2560", "height=1536",
                                     "tile=256,128"], "K1"),
                    ("hist", app_h, ["width=1536", "height=2560"], "K3")],
         "grad": (grad_by, grad_kw)})
    say(f"slice3_tools on {card}: " + json.dumps(tools))

    # blur sharded over a mesh of shard slots on this card, each shard one
    # K1 launch; the sharded histogram; the port's multichip dry run
    phase("distribute")
    cuda = torch.device("cuda")

    def timer(fn, n):
        return event_ms(fn, n, flush)

    def ktimer(fn, n):
        return event_ms(fn, n, flush, hold=True)

    dist, dr = distribute_phase(card, timer, ktimer, cuda, 2560, 1536,
                                (256, 128), DIST_SHARDS, (2560, 1536), 256)
    kernels.append(kernel_row(
        f"K1 stencil group (blur, distribute(y) over {DIST_SHARDS} shards "
        "of one card)", "halide_tpu_torch/ops/group_kernel.py",
        "halide_tpu/ops/pallas_group.py:696", dr["launches"], dr["err"],
        dr["k_ms"], dr["p_ms"], dr["nbytes"], dr["ops"], None,
        realize_ms=dr["realize_ms"],
        unsharded_realize_ms=dr["unsharded_realize_ms"],
        unsharded_k1_ms=dr["unsharded_k1_ms"], shards=dr["shards"],
        library_note="no single PyTorch call computes a fused group"))
    say(f"distribute on {card}: " + json.dumps(dist))

    # resnet_50 at the app's canonical size through the convolution and
    # einsum paths
    phase("resnet_50")
    rn, app_rn = resnet_phase(card, timer, ktimer, cuda)
    say(f"resnet_50 on {card}: " + json.dumps(rn))

    # the stage kernel on three main paths, each stage against its plain
    # version on the arrays the main path gave it
    phase("stage_kernel")
    for app, note in ((app_ll, "local_laplacian 1536x2560x3 u16"),
                      (app_c, "camera_pipe 2560x1920 u8, tile 2560x128"),
                      (app_rn, "resnet_50 batch 4, 224x224")):
        kernels.append(stage_phase(app, note, flush))

    # the port's 30 lessons, each main("cuda")
    phase("tutorials")
    gk.launches = 0
    secs = tutorials_phase(cuda)
    say(f"tutorials on {card}: K1 launches {gk.launches} over the 30 "
        f"lessons; seconds {json.dumps(secs)}")

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
