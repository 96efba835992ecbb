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
    ``tc.grad_clip == 0`` the gradients are not clipped. The arithmetic
    is `adamw_update_`'s, on copies."""
    new_p = {k: p.clone() for k, p in params.items()}
    new_state = {"mu": {k: m.clone() for k, m in state["mu"].items()},
                 "nu": {k: n.clone() for k, n in state["nu"].items()},
                 "count": state["count"]}
    metrics = adamw_update_(grads, new_state, new_p, tc, lr)
    return new_p, new_state, metrics


@torch.no_grad()
def adamw_update_(grads: Tree, state: Dict, params: Tree, tc: TrainConfig,
                  lr) -> Dict:
    """The reference's AdamW step in place: each parameter and the
    moments `state["mu"]`, `state["nu"]` are overwritten leaf by leaf (in
    the reference's order of operations), and `state["count"]` is
    replaced. Returns the metrics."""
    count = state["count"] + 1
    gn = global_norm(grads)
    scale = (torch.clamp(tc.grad_clip / (gn + 1e-9), max=1.0)
             if tc.grad_clip else 1.0)
    c = count.float()
    bc1 = 1.0 - tc.beta1 ** c
    bc2 = 1.0 - tc.beta2 ** c
    for k, p in params.items():
        mu, nu = state["mu"][k], state["nu"][k]
        gf = grads[k].float() * scale
        m = mu if mu.dtype == torch.float32 else mu.float()
        n = nu if nu.dtype == torch.float32 else nu.float()
        m.mul_(tc.beta1).add_(gf * (1 - tc.beta1))
        n.mul_(tc.beta2).add_(torch.square(gf).mul_(1 - tc.beta2))
        del gf
        step = torch.div(m, bc1).div_(torch.div(n, bc2).sqrt_().add_(tc.eps))
        if m is not mu:
            mu.copy_(m)
            nu.copy_(n)
        del m, n
        pf = p.float()
        step.add_(pf * tc.weight_decay).mul_(lr)
        if pf is p:
            p.sub_(step)
        else:
            p.copy_(pf.sub_(step))
        del step, pf
    state["count"] = count
    return {"grad_norm": gn, "lr": lr}
