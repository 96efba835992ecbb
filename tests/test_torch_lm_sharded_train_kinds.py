"""Training a placed LM (ROADMAP A item 4a) with the MoE and recurrent
kinds, on meshes of the CPU repeated, by the checks of
`test_torch_lm_sharded_train` (its tolerances): dbrx-132b (SiLU experts)
and grok-1-314b (GELU experts, soft-capped logits), 4 experts top-2,
their experts FSDP over "data" both ways (the tokens moved below
`moe.GATHER_WEIGHTS_AT`, the weights gathered at it, patched to 0),
with the aux loss on the global batch; rwkv6-3b (2 heads: at model 4 a
position's columns hold half a head, and the time mix regroups them into
whole (batch row, head) pairs, the state over its key dim);
recurrentgemma-9b (`rglru` with its f32 reduce-scatter of the gates, the
banded `local` attention, and one KV head of 4 query heads, so wk / wv
put "model" on d, `placement.FALLBACK_DIMS`)."""
import pytest

from repro_torch.nn import moe

from test_torch_lm_sharded_train import (  # noqa: F401 (a fixture)
    MESHES, Reference, check_step, no_kernels, three_steps)

CONFIGS = {
    "dbrx-132b": ("dbrx-132b", {}, False),
    "grok-1-314b": ("grok-1-314b", {}, False),
    "rwkv6-3b": ("rwkv6-3b", dict(num_layers=2), False),
    "recurrentgemma-9b": ("recurrentgemma-9b", {}, False),
}
REFERENCE = Reference(CONFIGS)
CASES = [(name, m) for name in CONFIGS for m in MESHES]


@pytest.mark.parametrize("name,mesh_shape", CASES)
def test_placed_step_matches_the_port_and_the_reference(name, mesh_shape,
                                                        no_kernels):
    check_step(REFERENCE(name), mesh_shape, f"{name} on {mesh_shape}")


@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2)])
@pytest.mark.parametrize("name", ["dbrx-132b", "grok-1-314b"])
def test_moe_step_gathering_the_weights(name, mesh_shape, no_kernels,
                                        monkeypatch):
    """The other FSDP way: every expert weight all-gathered over "data"
    before its product, the down-projection reduce-scattered."""
    monkeypatch.setattr(moe, "GATHER_WEIGHTS_AT", 0)
    check_step(REFERENCE(name), mesh_shape,
               f"{name} on {mesh_shape}, weights gathered")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_three_placed_steps_keep_replicas_equal(name, no_kernels):
    three_steps(REFERENCE(name), (2, 2), name)
