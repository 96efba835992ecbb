"""Load the JAX package's LM parameters into the port's `DecoderLM` (the
counterpart of `repro_torch.gnn.convert`)."""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.decoder_lm import DecoderLM
from repro_torch.nn.params import ParamGroup


def _copy(group: ParamGroup, tree: Mapping[str, Any], where: str) -> None:
    if set(tree) != set(group.defs):
        raise ValueError(f"{where}: keys {sorted(tree)}, expected "
                         f"{sorted(group.defs)}")
    for name, sub in tree.items():
        target = group[name]
        if isinstance(target, ParamGroup):
            _copy(target, sub, f"{where}.{name}")
            continue
        a = (sub if isinstance(sub, torch.Tensor)
             else torch.tensor(np.asarray(sub, np.float32)))
        if tuple(a.shape) != tuple(target.shape):
            raise ValueError(f"{where}.{name}: shape {tuple(a.shape)}, "
                             f"expected {tuple(target.shape)}")
        target.copy_(a)


@torch.no_grad()
def lm_params_from_numpy(cfg, tree: Mapping[str, Any],
                         device="cuda") -> DecoderLM:
    """`tree` is the JAX package's `init_params` pytree after
    ``jax.tree.map(np.asarray, ...)`` (or with torch tensors for leaves,
    as `repro_torch.checkpoint.read_tree` gives a checkpoint of it, bf16
    included): {"embed", "blocks", "rem", "final_norm", "lm_head"?,
    "encoder"?, "encoder_norm"?, "exits"?}. ``blocks[j]``
    stacks pattern position j over the R repeats, so layer ``r *
    len(pattern) + j`` is ``blocks[j]`` at index r; the remainder layers
    follow from ``rem``. ``encoder`` stacks the `enc` layers over
    `encoder_layers`, so encoder layer i is its index i. The scalar gates
    of `xattn` come across as 0-d arrays."""
    model = DecoderLM(cfg, resolve_device(device))
    P, R = len(cfg.pattern), cfg.pattern_repeats
    top = {k: tree[k] for k in ("embed", "final_norm", "lm_head",
                                "encoder_norm", "exits") if k in tree}
    _copy(model.top, top, "params")
    for i, layer in enumerate(model.encoder):
        _copy(layer, _index(tree["encoder"], i), f"encoder[{i}]")
    for i, layer in enumerate(model.layers):
        if i < R * P:
            r, j = divmod(i, P)
            sub = _index(tree["blocks"][j], r)
        else:
            sub = tree["rem"][i - R * P]
        _copy(layer, sub, f"layers[{i}]")
    return model.eval()


def _index(tree, r: int):
    """The r-th slice of every array of a stacked subtree."""
    if isinstance(tree, Mapping):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r] if isinstance(tree, torch.Tensor) else np.asarray(tree)[r]
