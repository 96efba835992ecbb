"""Training a placed LM (ROADMAP A item 4a) with the frontend kinds, on
meshes of the CPU repeated, by the checks of
`test_torch_lm_sharded_train` (its tolerances): llama-3.2-vision-11b
(`attn` and gated `xattn` over the placed image rows), whisper-small
(the `enc` encoder on the placed frames, `encdec` with its cross-
attention) and "whisper-v511" (vocab 511, which the model axis does not
divide: the embedding P(None, 'model') looked up in its columns, the
head P('model', None) row-parallel)."""
import pytest

from test_torch_lm_sharded_train import (  # noqa: F401 (a fixture)
    MESHES, Reference, check_step, no_kernels, three_steps)

CONFIGS = {
    "llama-3.2-vision-11b": ("llama-3.2-vision-11b", {}, False),
    "whisper-small": ("whisper-small", {}, False),
    "whisper-v511": ("whisper-small", dict(vocab_size=511), False),
}
REFERENCE = Reference(CONFIGS)


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_placed_step_matches_the_port_and_the_reference(name, mesh_shape,
                                                        no_kernels):
    check_step(REFERENCE(name), mesh_shape, f"{name} on {mesh_shape}")


@pytest.mark.parametrize("name", ["llama-3.2-vision-11b", "whisper-v511"])
def test_three_placed_steps_keep_replicas_equal(name, no_kernels):
    three_steps(REFERENCE(name), (2, 2), name)
