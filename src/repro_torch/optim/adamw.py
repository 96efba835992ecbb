"""AdamW with global-norm clipping on dicts of tensors (the port of
`repro.optim.adamw`).

The update is the reference's, not `torch.optim.AdamW`'s: the decay is
``p - lr * (step + wd * p)`` on every leaf (biases included), eps is added
after ``sqrt(nu / bc2)``, the bias corrections are taken in float32, and
the moments are kept in `TrainConfig.moment_dtype`. Parameters, gradients
and moments are trees of the same structure: a dict ``name -> tensor``
(for a module, ``dict(module.named_parameters())``), or the nested dicts
and lists of a placed model (`repro_torch.sharding.placement.
shard_params`), whose leaves are `ShardedTensor`s.

On a placed tree the moments are placed as their parameters are (the
reference's `opt_state_specs`), the global norm counts each logical
element once (every distinct block once, never a copy twice), and every
position's block takes the same arithmetic with the same scalars, so
that the copies of a block stay equal bit for bit when their gradients
are (`placement.sync_grads`).
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from repro_torch.common import TrainConfig
from repro_torch.sharding import placement as pl

Tree = Mapping[str, torch.Tensor]


def _pairs(*trees):
    """The leaves of trees of the same structure, as tuples."""
    first = trees[0]
    if isinstance(first, Mapping):
        for k in first:
            yield from _pairs(*(t[k] for t in trees))
    elif isinstance(first, (list, tuple)):
        for i in range(len(first)):
            yield from _pairs(*(t[i] for t in trees))
    else:
        yield trees


def _map(fn, tree):
    """fn over each tensor of a tree, block by block for a placed leaf."""
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    if pl.is_sharded(tree):
        return pl.wrap([fn(b) for b in tree.locals], tree.spec, tree.mesh)
    return fn(tree)


def _sum_squares(x):
    """The f32 sum of squares of a tensor, or of a placed tensor's
    distinct blocks (on the mesh's first device)."""
    if not pl.is_sharded(x):
        return torch.sum(torch.square(x.float()))
    dev = x.mesh.devices[0]
    return sum(torch.sum(torch.square(x.locals[i].float())).to(dev)
               for i in pl.distinct(x))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(_sum_squares(x) for (x,) in _pairs(tree)))


def adamw_init(params, tc: TrainConfig) -> Dict:
    mdt = getattr(torch, tc.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)
    return {"mu": _map(zeros, params), "nu": _map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32)}


@torch.no_grad()
def adamw_update(grads, state: Mapping, params, tc: TrainConfig, lr):
    """Returns (new_params, new_state, metrics); the inputs are left as
    they are. `lr` is a float or a 0-dim tensor (`make_schedule`). With
    ``tc.grad_clip == 0`` the gradients are not clipped. The arithmetic
    is `adamw_update_`'s, on copies."""
    def copy(t):
        return t.clone()
    new_p = _map(copy, params)
    new_state = {"mu": _map(copy, state["mu"]),
                 "nu": _map(copy, state["nu"]), "count": state["count"]}
    metrics = adamw_update_(grads, new_state, new_p, tc, lr)
    return new_p, new_state, metrics


@torch.no_grad()
def adamw_update_(grads, state: Dict, params, tc: TrainConfig,
                  lr) -> Dict:
    """The reference's AdamW step in place: each parameter and the
    moments `state["mu"]`, `state["nu"]` are overwritten leaf by leaf (in
    the reference's order of operations; a placed leaf block by block),
    and `state["count"]` is replaced. Returns the metrics."""
    count = state["count"] + 1
    gn = global_norm(grads)
    scale = (torch.clamp(tc.grad_clip / (gn + 1e-9), max=1.0)
             if tc.grad_clip else 1.0)
    c = count.float()
    bc1 = 1.0 - tc.beta1 ** c
    bc2 = 1.0 - tc.beta2 ** c
    for p, g, mu, nu in _pairs(params, grads, state["mu"], state["nu"]):
        if not pl.is_sharded(p):
            _update_leaf(p, g, mu, nu, scale, bc1, bc2, tc, lr)
            continue
        for blocks in zip(p.locals, g.locals, mu.locals, nu.locals):
            s = scale.to(blocks[0].device) if torch.is_tensor(scale) \
                else scale
            _update_leaf(*blocks, s, bc1, bc2, tc, lr)
    state["count"] = count
    return {"grad_norm": gn, "lr": lr}


def _update_leaf(p, g, mu, nu, scale, bc1, bc2, tc: TrainConfig, lr):
    """One leaf's (or block's) AdamW step in place."""
    gf = g.float() * scale
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
