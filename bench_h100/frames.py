"""The one traffic generator: a closed loop of frames, one in flight, fed
by a ring of input frames made on the device from the seed. A traffic
mix's file gives its parameters: the configuration's size to run at
(`size`) and the frames whose outputs are kept for the check
(`check_frames`)."""
from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .peaks import L2_BYTES
from .spec import Cell

# the ring holds half as much again as the card's L2, so that a frame's
# input has left the L2 when its slot comes round, as a new frame's has
# never been in it; and at least two frames, so that no two frames in a
# row read one input
RING_MIN_BYTES = 3 * L2_BYTES // 2
RING_MIN_FRAMES = 2


def resolve_shape(shape, size) -> List[int]:
    """A configuration's shape: each entry an int, or [var, offset] with
    var "w" or "h", the output's width or height."""
    w, h = size
    out = []
    for d in shape:
        if isinstance(d, int):
            out.append(d)
        else:
            var, off = d
            out.append({"w": w, "h": h}[var] + int(off))
    return out


def ring_length(frame_bytes: int) -> int:
    return max(RING_MIN_FRAMES, math.ceil(RING_MIN_BYTES / frame_bytes))


@dataclass
class Inputs:
    ring: Dict[str, torch.Tensor]        # name -> [frames, ...]
    fixed: Dict[str, torch.Tensor]       # name -> tensor, bound once
    frames: int

    def frame(self, slot: int) -> Dict[str, torch.Tensor]:
        """Every input of ring slot `slot`, as the reference takes them."""
        return {**self.fixed, **{k: v[slot] for k, v in self.ring.items()}}


def make_inputs(cell: Cell, seed: int, device,
                frames: Optional[int] = None) -> Inputs:
    """Every input of the configuration from `seed`, on `device`: one
    generator, each input kind in one call over the whole ring (of
    `frames` frames where given, else `ring_length`'s)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    specs = cell.config["inputs"]
    per_frame = 0
    for s in specs:
        if s.get("ring"):
            n = math.prod(resolve_shape(s["shape"], cell.size))
            per_frame += n * torch.empty((), dtype=getattr(
                torch, s["dtype"])).element_size()
    if frames is None:
        frames = ring_length(per_frame) if per_frame else 1
    ring, fixed = {}, {}
    for s in specs:
        shape = resolve_shape(s["shape"], cell.size)
        kind = cell.input_kind(s["kind"])
        if s.get("ring"):
            ring[s["name"]] = kind.make(s, [frames] + shape, gen, device)
        else:
            fixed[s["name"]] = kind.make(s, shape, gen, device)
    return Inputs(ring, fixed, frames)


def build_app(cell: Cell):
    """The configuration's app, built at the cell's size with the pinned
    arguments (a list becomes a tuple: a tile)."""
    from halide_tpu_torch.apps import get
    args = {k: tuple(v) if isinstance(v, list) else v
            for k, v in cell.config["args"].items()}
    wk, hk = cell.config["size_args"]
    return get(cell.config["app"])(**args, **{wk: cell.size[0],
                                              hk: cell.size[1]})


@dataclass
class Span:
    """One frame's host-clock marks (perf_counter seconds): the bind, the
    call into `Pipeline.realize`, its return, and the synchronize's."""
    bind: float
    call: float
    ret: float
    done: float


@dataclass
class Stream:
    """A closed loop of frames over one app and one ring of inputs."""
    app: object
    inputs: Inputs
    device: torch.device
    realize: Optional[Callable] = None    # the call under test
    count: int = 0                        # frames run so far
    last: object = None                   # the last frame's output Buffer
    params: Dict[str, object] = field(init=False)

    def __post_init__(self):
        self.params = {p.name: p for p in self.app.inputs}
        for name, t in self.inputs.fixed.items():
            self.params[name].set(t)
        if self.realize is None:
            self.realize = self.app.pipeline.realize

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def frame(self) -> Tuple[int, Span]:
        """Bind the next ring slot, realize, synchronize: -> (slot, span)."""
        slot = self.count % self.inputs.frames
        t0 = time.perf_counter()
        for name, t in self.inputs.ring.items():
            self.params[name].set(t[slot])
        t1 = time.perf_counter()
        self.last = self.realize(self.app.output_sizes, device=self.device)
        t2 = time.perf_counter()
        self.sync()
        t3 = time.perf_counter()
        self.count += 1
        return slot, Span(t0, t1, t2, t3)


@dataclass
class Window:
    spans: List[Span]
    seconds: float                       # first bind to the last sync's end
    kept: List[Tuple[int, int, object]]  # (frame, ring slot, output Buffer)


def run_window(stream: Stream, seconds: float, keep: int,
               rng: random.Random) -> Window:
    """Frames until `seconds` have passed; the outputs of `keep` frames
    drawn uniformly from the window's frames by `rng` are kept (a reservoir
    sample: the count of frames is not known until the window closes)."""
    spans, kept = [], []
    t0 = time.perf_counter()
    n = 0
    while True:
        slot, sp = stream.frame()
        spans.append(sp)
        if len(kept) < keep:
            kept.append((n, slot, stream.last))
        else:
            j = rng.randrange(n + 1)
            if j < keep:
                kept[j] = (n, slot, stream.last)
        n += 1
        if sp.done - t0 >= seconds:
            break
    return Window(spans, spans[-1].done - t0, kept)
