"""Logical-axis sharding of the port (`repro.sharding`): the rules, specs
and fitting of `logical`, and the placed tensors and collectives of
`placement`, which stand in for GSPMD on the port's single-controller
`DeviceMesh`."""
from repro_torch.sharding.logical import (DEFAULT_RULES, P, NamedSharding,
                                          constrain, current_mesh, fit_spec,
                                          named, resolve, spec, use_mesh)

__all__ = ["DEFAULT_RULES", "P", "NamedSharding", "constrain",
           "current_mesh", "fit_spec", "named", "resolve", "spec",
           "use_mesh"]
