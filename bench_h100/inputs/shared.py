"""One draw given to every frame of the ring: a weight that a deployment
holds once and that every frame reads whole, declared `ring` so that the
ring's bytes a frame count it. {"kind": "shared", "law": <another kind>,
...the law's own keys}: the law draws one frame's tensor, and every slot
is that tensor (a view over the ring's axis, stride 0), so the ring holds
it once and binding a slot copies nothing."""
from pathlib import Path

import torch

from bench_h100.spec import load_module


def make(spec: dict, shape, generator: torch.Generator,
         device) -> torch.Tensor:
    law = load_module(Path(__file__).resolve().parent / f"{spec['law']}.py")
    one = law.make(spec, list(shape[1:]), generator, device)
    return one.unsqueeze(0).expand(tuple(shape))
