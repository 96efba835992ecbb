"""AdamW with global-norm clipping on dicts of tensors (the port of
`repro.optim.adamw`).

The update is the reference's, not `torch.optim.AdamW`'s: the decay is
``p - lr * (step + wd * p)`` on every leaf (biases included), eps is added
after ``sqrt(nu / bc2)``, the bias corrections are taken in float32, and
the moments are kept in `TrainConfig.moment_dtype`. Parameters, gradients
and moments are dicts ``name -> tensor`` with the same keys (for a module,
``dict(module.named_parameters())``).
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from repro_torch.common import TrainConfig

Tree = Mapping[str, torch.Tensor]


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def adamw_init(params: Tree, tc: TrainConfig) -> Dict:
    mdt = getattr(torch, tc.moment_dtype)
    return {
        "mu": {k: torch.zeros(p.shape, dtype=mdt, device=p.device)
               for k, p in params.items()},
        "nu": {k: torch.zeros(p.shape, dtype=mdt, device=p.device)
               for k, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32),
    }


@torch.no_grad()
def adamw_update(grads: Tree, state: Mapping, params: Tree,
                 tc: TrainConfig, lr):
    """Returns (new_params, new_state, metrics); the inputs are left as
    they are. `lr` is a float or a 0-dim tensor (`make_schedule`). With
    ``tc.grad_clip == 0`` the gradients are not clipped."""
    count = state["count"] + 1
    gn = global_norm(grads)
    scale = (torch.clamp(tc.grad_clip / (gn + 1e-9), max=1.0)
             if tc.grad_clip else 1.0)
    c = count.float()
    bc1 = 1.0 - tc.beta1 ** c
    bc2 = 1.0 - tc.beta2 ** c
    mdt = getattr(torch, tc.moment_dtype)
    new_p, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        gf = grads[k].float() * scale
        mu2 = tc.beta1 * state["mu"][k].float() + (1 - tc.beta1) * gf
        nu2 = (tc.beta2 * state["nu"][k].float()
               + (1 - tc.beta2) * torch.square(gf))
        step = (mu2 / bc1) / (torch.sqrt(nu2 / bc2) + tc.eps)
        pf = p.float()
        pf = pf - lr * (step + tc.weight_decay * pf)
        new_p[k] = pf.to(p.dtype)
        new_mu[k], new_nu[k] = mu2.to(mdt), nu2.to(mdt)
    metrics = {"grad_norm": gn, "lr": lr}
    return new_p, {"mu": new_mu, "nu": new_nu, "count": count}, metrics
