"""Parameter definitions, as in `repro.nn.params`.

A model declares its parameters once as a nested dict of `ParamDef`s
(shape + logical axes + initializer). `ParamGroup` turns such a dict into
an `nn.Module` whose parameters carry the JAX package's names, so the
layer functions read ``p["w_r"]`` in both packages, and `init_group`
fills it from an explicit `torch.Generator` with the reference's
initializers and scales (the numbers differ: torch and jax generators
give different streams from one seed). The sharding specs and abstract
trees of the JAX module wait for the sharding slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "fan_in"          # fan_in | normal | zeros | ones | embed | small
    scale: float = 1.0
    dtype: Optional[str] = None   # override model param dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def torch_dtype(name: str) -> torch.dtype:
    """'bfloat16' / 'float32' / ... as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


class ParamGroup(nn.Module):
    """A nested dict of `ParamDef`s as a module: a leaf becomes a
    parameter (no gradient: the port infers), a dict a child group, each
    under its JAX name; ``group[name]`` reads either."""

    def __init__(self, defs: dict, dtype: str, device):
        super().__init__()
        for name, d in defs.items():
            if isinstance(d, ParamDef):
                self.register_parameter(name, nn.Parameter(torch.empty(
                    d.shape, dtype=torch_dtype(d.dtype or dtype),
                    device=device), requires_grad=False))
            else:
                self.add_module(name, ParamGroup(d, dtype, device))
        self.defs = defs

    def __getitem__(self, name: str):
        return getattr(self, name)


def _init_std(d: ParamDef) -> Optional[float]:
    """Standard deviation of a normal initializer (None: constant)."""
    if d.init in ("zeros", "ones"):
        return None
    if d.init == "normal":
        return d.scale
    if d.init == "embed":
        return d.scale / math.sqrt(d.shape[-1])
    if d.init == "small":
        return 0.02 * d.scale
    if d.init == "fan_in":
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        return d.scale / math.sqrt(max(fan_in, 1))
    raise ValueError(f"unknown init {d.init!r}")


@torch.no_grad()
def init_group(group: ParamGroup, generator: torch.Generator) -> None:
    """Fill every parameter of `group` in place: f32 normals from
    `generator` (on the generator's device) times the initializer's
    scale, cast to the parameter's dtype."""
    for name, d in group.defs.items():
        if not isinstance(d, ParamDef):
            init_group(group[name], generator)
            continue
        p = group[name]
        std = _init_std(d)
        if std is None:
            p.fill_(1.0 if d.init == "ones" else 0.0)
        else:
            p.copy_(torch.randn(d.shape, generator=generator,
                                device=generator.device) * std)


def count_params(module: nn.Module) -> int:
    """Number of parameter scalars of a module."""
    return sum(p.numel() for p in module.parameters())
