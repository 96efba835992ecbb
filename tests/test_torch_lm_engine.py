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
                                  "recurrentgemma-9b"])
def test_engine_tokens_match_reference(arch):
    jcfg, tcfg = jax_smoke(JAX_ARCHS[arch]), smoke(ARCHS[arch])
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    engines = (JaxLMEngine(jcfg, params, slots=3, max_len=64),
               LMServingEngine(tcfg, model, slots=3, max_len=64,
                               device="cpu"))
    stats = []
    for eng in engines:
        for p in PROMPTS:                  # more requests than slots
            eng.submit(p, max_new=5)
        stats.append(eng.run_until_drained())
    assert stats[0] == {**stats[1], "mean_latency_s":
                        stats[0]["mean_latency_s"]}
    assert stats[1]["completed"] == len(PROMPTS)
    ref = {r.rid: (r.prompt, r.out) for r in engines[0].completed}
    got = {r.rid: (r.prompt, r.out) for r in engines[1].completed}
    assert got == ref
    assert all(len(out) == 5 for _, out in got.values())


def test_engine_outputs_do_not_depend_on_neighbours():
    """A request alone in the engine gets the tokens it got among six
    others (lanes are independent batch rows)."""
    cfg = smoke(ARCHS["rwkv6-3b"])
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
