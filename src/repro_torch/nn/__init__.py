"""Layers of the LM substrate (`repro.nn`): parameter definitions, norms
and MLPs, RWKV6, RG-LRU, attention and the per-kind blocks."""
from repro_torch.nn.params import (ParamDef, ParamGroup, count_params,
                                   init_group)

__all__ = ["ParamDef", "ParamGroup", "count_params", "init_group"]
