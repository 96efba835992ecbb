"""The train-step half of the reference's multi-pod dry run
(`repro.launch.dryrun`): the training configuration a model gets, its
step, and the optimizer state's shapes and partition specs.

    step, tc = build_train_step(cfg)
    params = placement.shard_params(model, mesh, trainable=True)
    opt = adamw_init(params, tc)          # moments placed as the params
    with use_mesh(mesh):
        params, opt, metrics = step(params, opt, batch)

The reference jits its step with the parameters and the moments placed by
`param_specs` and `opt_state_specs`; here the step runs eagerly on a
placed tree (`launch.train.lm_train_step`: `loss_fn`, its gradients
summed over the axes each leaf's spec leaves free, the in-place AdamW),
or on a module off a mesh. Still queued (ROADMAP A11): `lower_combo`,
the memory and cost report and `main`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common import TrainConfig
from repro_torch.launch.train import lm_train_step
from repro_torch.models import decoder_lm as M
from repro_torch.nn.params import torch_dtype
from repro_torch.optim import make_schedule
from repro_torch.sharding.logical import spec as logical_spec
from repro_torch.sharding.placement import named_leaves

# above this many parameters the Adam moments are kept in bf16
BF16_MOMENTS_ABOVE = 60e9


def _train_cfg(cfg) -> TrainConfig:
    """The reference's defaults, with bf16 Adam moments for a model of
    more than 60e9 parameters and f32 ones otherwise."""
    n = sum(t.numel() for _, t in named_leaves(M.abstract_params(cfg)))
    mdt = "bfloat16" if n > BF16_MOMENTS_ABOVE else "float32"
    return TrainConfig(moment_dtype=mdt)


def build_train_step(cfg, **overrides):
    """(train_step, tc): `_train_cfg(cfg)` with `overrides` (TrainConfig
    fields), and train_step(params, opt_state, batch) -> (params,
    opt_state, metrics), which updates `params` (a module, or a placed
    tree inside `use_mesh`) and `opt_state` in place and returns them."""
    tc = dataclasses.replace(_train_cfg(cfg), **overrides)
    sched = make_schedule(tc)

    def train_step(params, opt_state, batch):
        metrics = lm_train_step(cfg, params, opt_state, tc, sched, batch)
        return params, opt_state, metrics

    return train_step, tc


def abstract_opt_state(cfg, tc: TrainConfig):
    """The optimizer state as `meta` tensors: the moments in
    `tc.moment_dtype`, shaped as the parameters (`model_defs`' tree), and
    the int32 step count."""
    mdt = torch_dtype(tc.moment_dtype)

    def moments(t):
        if isinstance(t, dict):
            return {k: moments(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [moments(v) for v in t]
        return torch.empty(t.shape, dtype=mdt, device="meta")
    mom = moments(M.abstract_params(cfg))
    return {"mu": mom, "nu": mom,
            "count": torch.empty((), dtype=torch.int32, device="meta")}


def opt_state_specs(cfg):
    """The optimizer state's partition specs: each moment's is its
    parameter's, the count replicated."""
    ps = M.param_specs(cfg)
    return {"mu": ps, "nu": ps, "count": logical_spec()}
