"""A mesh of shard slots, each on a torch.device.

The JAX package shards over a `jax.sharding.Mesh` from one process: one
`shard_map` program runs on every device of the mesh. The port keeps that
single-controller model. A `Mesh` is an array of slots, one per shard,
with named axes; a shard's work runs on its slot's device, and halo rows
and partials move between slots by `Tensor.to`. A device may fill several
slots: eight slots on "cpu" are the counterpart of the JAX tests' eight
virtual CPU devices, and n slots on "cuda:0" shard a realize on one card.
On a machine with several cards the same code copies between them.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np
import torch


class Mesh:
    """Mesh(devices, axis_names): `devices` a nested list, or a numpy
    object array, of torch.device or device strings; `axis_names` one name
    per axis of that array. `shape` maps each axis name to its size, as
    jax.sharding.Mesh.shape does."""

    def __init__(self, devices, axis_names: Union[str, Sequence[str]]):
        if isinstance(axis_names, str):
            axis_names = (axis_names,)
        arr = np.array(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(
                f"Mesh: {arr.ndim}-d device array, {len(axis_names)} axis "
                "names")
        self.devices = np.vectorize(torch.device, otypes=[object])(arr)
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.devices.shape))

    def axis_devices(self, axis_name: str) -> List[torch.device]:
        """The devices of the slots along `axis_name`, one per shard (the
        first slot of every other axis: shards that a spec does not split
        over hold the same values)."""
        k = self.axis_names.index(axis_name)
        d = np.moveaxis(self.devices, k, 0).reshape(self.devices.shape[k],
                                                    -1)
        return [d[i, 0] for i in range(d.shape[0])]
