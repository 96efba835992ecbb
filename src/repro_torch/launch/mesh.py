"""Device meshes of the port (`repro.launch.mesh`).

The port runs sharded work from ONE controlling process: the process packs
every shard, holds an ordered list of devices, and moves blocks between
shards as tensor copies (`repro_torch.gnn.backends`). A `DeviceMesh` is
that list with named axes. Device position along ``data`` IS the shard id
that the packer's halo metadata names, so a mesh must not reorder its
devices between packing and dispatch.

On a machine with D GPUs, shard d lives on ``cuda:d`` and the copies
between shards are peer copies. A mesh may also repeat a device — D shards
on one card (``devices=("cuda:0",) * D``) or on the CPU (``("cpu",) * D``)
— which runs the same code and the same exchanges, and so shows
correctness and the exchange's cost, not the capacity of D cards. Such a
mesh is only built from an explicit ``devices=``. So is a mesh of `meta`
devices (``("meta",) * 256``): the production mesh of the dry run
(`launch.dryrun`), whose blocks have shapes and no memory.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.common import MeshConfig
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """An ordered, row-major grid of torch devices with named axes:
    ``devices[i * shape[ax1] + j]`` sits at index (i, j) of a 2-D mesh."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    dims: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.dims):
            raise ValueError(f"axis names {self.axis_names} and dims "
                             f"{self.dims} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"duplicate axis names {self.axis_names}")
        if math.prod(self.dims) != len(self.devices) or not self.devices:
            raise ValueError(f"{len(self.devices)} devices do not fill a "
                             f"mesh of dims {self.dims}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``mesh.shape["data"]`` reads in the JAX
        package."""
        return dict(zip(self.axis_names, self.dims))

    def __str__(self) -> str:
        axes = " ".join(f"{a}={d}" for a, d in zip(self.axis_names,
                                                   self.dims))
        kinds = sorted(set(map(str, self.devices)), key=str)
        on = (f"{kinds[0]} x{len(self.devices)}" if len(kinds) == 1
              else ", ".join(map(str, self.devices)))
        return f"mesh {axes} on ({on})"


def make_mesh(devices: Sequence, shape: Dict[str, int]) -> DeviceMesh:
    """A mesh of `devices` (names or torch.devices, row-major) with the
    axes of `shape` in order, e.g. ``make_mesh(("cpu",) * 4, {"data": 2,
    "model": 2})``. CUDA devices are checked to exist."""
    devs = tuple(resolve_device(d) for d in devices)
    for d in devs:
        if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
            raise ValueError(f"{d} requested but only "
                             f"{torch.cuda.device_count()} GPUs exist")
    return DeviceMesh(devs, tuple(shape), tuple(int(v)
                                                for v in shape.values()))


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> DeviceMesh:
    """16 x 16 = 256 positions ("data", "model"), or 2 x 16 x 16 = 512
    ("pod", "data", "model") with `multi_pod`: "data" carries the batch
    and FSDP, "model" the tensor parallelism, "pod" pure data parallelism
    (the logical rules put "batch" over ("pod", "data")). Without
    `devices`: the first 256 or 512 GPUs, raising when fewer exist; with
    them (``("meta",) * 256`` for the dry run): those devices."""
    mc = MeshConfig(multi_pod=multi_pod)
    n = math.prod(mc.shape)
    if devices is None:
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > avail:
            raise ValueError(f"make_production_mesh(multi_pod={multi_pod}): "
                             f"{n} GPUs needed, only {avail} available "
                             f"(pass devices=, e.g. ('meta',) * {n})")
        devices = [f"cuda:{i}" for i in range(n)]
    return make_mesh(devices, dict(zip(mc.axes, mc.shape)))


def make_debug_mesh(n_devices: int = 1, *,
                    devices: Optional[Sequence] = None) -> DeviceMesh:
    """A ("data", "model") mesh of shape 1 x n: the first `n_devices`
    GPUs, or the given `devices` (which may repeat one, e.g. ``("cpu",) *
    4``), all on the model axis."""
    if devices is None:
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_devices > avail:
            raise ValueError(f"make_debug_mesh({n_devices}): only {avail} "
                             f"GPUs available (pass devices= to place "
                             f"several positions on one device)")
        devices = [f"cuda:{i}" for i in range(n_devices)]
    return make_mesh(devices, {"data": 1, "model": len(devices)})


def make_serving_mesh(n_data: int = 0, *,
                      devices: Optional[Sequence] = None) -> DeviceMesh:
    """1-D ``("data",)`` mesh: the GNN serving engine's row-sharding mesh
    (packed support rows partition over ``data``, features stay whole).

    Without `devices`: the first `n_data` GPUs, ``cuda:0 .. cuda:n-1``
    (every GPU when 0). Raises when fewer exist: serving fewer shards than
    asked for would defeat the reason to shard, and nothing drops to the
    CPU. With `devices` (which may repeat one device, e.g. ``("cuda:0",)
    * 4`` for four shards on one card): those devices, `n_data` 0 or
    their count."""
    if devices is None:
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_data > avail or avail == 0:
            raise ValueError(f"make_serving_mesh({n_data}): only {avail} "
                             f"GPUs available (pass devices= to place "
                             f"several shards on one device)")
        devices = [f"cuda:{i}" for i in range(n_data or avail)]
    elif n_data and n_data != len(devices):
        raise ValueError(f"make_serving_mesh({n_data}) got "
                         f"{len(devices)} devices")
    return make_mesh(devices, {"data": len(devices)})
