"""The port's `LMServingEngine` against the JAX package's, on the CPU at
`smoke()` sizes: the same weights (through `lm_params_from_numpy`) and
the same prompts give the same greedy tokens, request by request, with
more requests than slots (slots 3, max_len 64, as the reference's own
engine test). Tokens are compared exactly: the logits agree to ~1e-5
(tests/test_torch_lm_models.py) and the random-weight models have no
near-ties at these seeds."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, smoke as jax_smoke
from repro.models import decoder_lm as JM
from repro.serving.lm_engine import LMServingEngine as JaxLMEngine
from repro_torch.configs import ARCHS, smoke
from repro_torch.models import decoder_lm as M
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.serving import LMServingEngine

PROMPTS = [[1 + i, 2, 3] for i in range(7)]


@pytest.mark.parametrize("arch", ["granite-34b", "rwkv6-3b",
                                  "recurrentgemma-9b", "dbrx-132b",
                                  "grok-1-314b"])
def test_engine_tokens_match_reference(arch):
    _engines_agree(arch, slots=3, prompts=PROMPTS)


def test_moe_engine_tokens_match_reference_where_capacity_binds():
    """dbrx smoke (4 experts, top-2) at 12 slots: a tick routes the 12
    lanes as one row at capacity 8, and the experts overflow it, so a
    lane's tokens depend on its neighbours; the port's engine still gives
    the reference's tokens (no isolation the reference lacks)."""
    from repro_torch.nn import moe
    prompts = [[1 + i, 2 + 3 * i, 3] for i in range(12)]
    moe.apply_moe.drops = []
    try:
        _engines_agree("dbrx-132b", slots=12, prompts=prompts)
        assert sum(int(d) for d, _ in moe.apply_moe.drops) > 0
    finally:
        moe.apply_moe.drops = None


def _engines_agree(arch, slots, prompts):
    jcfg, tcfg = jax_smoke(JAX_ARCHS[arch]), smoke(ARCHS[arch])
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    engines = (JaxLMEngine(jcfg, params, slots=slots, max_len=64),
               LMServingEngine(tcfg, model, slots=slots, max_len=64,
                               device="cpu"))
    stats = []
    for eng in engines:
        for p in prompts:
            eng.submit(p, max_new=5)
        stats.append(eng.run_until_drained())
    assert stats[0] == {**stats[1], "mean_latency_s":
                        stats[0]["mean_latency_s"]}
    assert stats[1]["completed"] == len(prompts)
    ref = {r.rid: (r.prompt, r.out) for r in engines[0].completed}
    got = {r.rid: (r.prompt, r.out) for r in engines[1].completed}
    assert got == ref
    assert all(len(out) == 5 for _, out in got.values())


def test_engine_outputs_do_not_depend_on_neighbours():
    """A request alone in the engine gets the tokens it got among six
    others (lanes are independent batch rows)."""
    _alone_equals_among_others("rwkv6-3b")


def test_moe_engine_outputs_do_not_depend_on_neighbours():
    """The same for dbrx smoke at 3 slots: a tick routes the lanes as one
    row, but 3 tokens cannot overflow an expert's capacity of 8."""
    _alone_equals_among_others("dbrx-132b")


def _alone_equals_among_others(arch):
    cfg = smoke(ARCHS[arch])
    model = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = LMServingEngine(cfg, model, slots=3, max_len=64, device="cpu")
    for p in PROMPTS:
        eng.submit(p, max_new=5)
    eng.run_until_drained()
    alone = LMServingEngine(cfg, model, slots=3, max_len=64, device="cpu")
    alone.submit(PROMPTS[0], max_new=5)
    alone.run_until_drained()
    first = next(r for r in eng.completed if r.prompt == PROMPTS[0])
    assert first.out == alone.completed[0].out
