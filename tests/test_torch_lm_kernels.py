"""The port's LM kernels B4 (flash attention) and B5 (WKV6) on the CPU,
where each wrapper takes its plain PyTorch version, against the JAX
package: its Pallas kernels in interpret mode, its oracles and the layer
function the kernels compute. Inputs come from numpy and go to both.

Tolerances: WKV6 at rtol = atol = 2e-4 against the f64 sequential
recurrence and the Pallas kernel (the chunked f32 factorization carries
exp(+-80)-sized factors, the bound of `repro`'s own kernel test), and at
rtol = atol = 1e-4 against `_wkv_chunked` (the same factorization summed
in another order; the large factors cost about four digits of f32);
flash attention at rtol = 2e-4, atol = 2e-5 in f32 (`repro`'s own sweep
bound; softmax sums in another order) and at
rtol = atol = 0.05 for bf16 inputs against the f32 oracle (the bound of
`repro`'s bf16 test: one bf16 rounding of inputs and output)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import (flash_attention as jax_flash,
                                           gqa_flash_attention as jax_gqa,
                                           ref_attention as jax_ref_attention)
from repro.kernels.wkv6 import (ref_wkv6_sequential, wkv6 as jax_wkv6,
                                wkv6_heads as jax_wkv6_heads)
from repro.nn.rwkv import _wkv_chunked
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 gqa_flash_attention,
                                                 ref_attention)
from repro_torch.kernels.wkv6 import CHUNK, ref_wkv6, wkv6, wkv6_heads


def _wkv_inputs(rng, B, T, H, hd):
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    logw = np.maximum(-np.exp(rng.standard_normal((B, T, H, hd)) * 0.5),
                      -5.0).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    return r, k, v, logw, u


def _flat(a):
    B, T, H, hd = a.shape
    return a.transpose(0, 2, 1, 3).reshape(B * H, T, hd)


# -------------------------------------------------------------------- wkv6
@pytest.mark.parametrize("T,hd,H", [(32, 16, 2), (40, 16, 3), (64, 32, 1)])
def test_wkv6_heads_matches_pallas_and_sequential(rng, T, hd, H):
    B = 2
    r, k, v, logw, u = _wkv_inputs(rng, B, T, H, hd)
    before = wkv6.launches
    out, state = wkv6_heads(*map(torch.tensor, (r, k, v, logw, u)))
    assert wkv6.launches == before          # the plain version ran
    assert out.shape == (B, T, H, hd) and state.shape == (B, H, hd, hd)
    pallas = jax_wkv6_heads(*map(jnp.asarray, (r, k, v, logw, u)),
                            interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), rtol=2e-4,
                               atol=2e-4)
    seq = ref_wkv6_sequential(
        _flat(r), _flat(k), _flat(v), _flat(logw),
        np.broadcast_to(u[None], (B, H, hd)).reshape(B * H, hd)
    ).reshape(B, H, T, hd).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(out.numpy(), seq, rtol=2e-4, atol=2e-4)


def test_wkv6_out_and_state_match_wkv_chunked(rng):
    B, T, H, hd = 2, 48, 2, 32
    r, k, v, logw, u = _wkv_inputs(rng, B, T, H, hd)
    out, state = wkv6_heads(*map(torch.tensor, (r, k, v, logw, u)))
    j_out, j_state = _wkv_chunked(*map(jnp.asarray, (r, k, v, logw, u)),
                                  jnp.zeros((B, H, hd, hd), jnp.float32))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(state.numpy(), np.asarray(j_state),
                               rtol=1e-4, atol=1e-4)


def test_wkv6_flat_matches_pallas_kernel(rng):
    BH, T, hd = 3, 4 * CHUNK, 16
    r, k, v, logw, _ = _wkv_inputs(rng, 1, T, BH, hd)
    r, k, v, logw = (a[0].transpose(1, 0, 2).copy() for a in (r, k, v, logw))
    u = (rng.standard_normal((BH, hd)) * 0.1).astype(np.float32)
    out, _ = wkv6(*map(torch.tensor, (r, k, v, logw, u)))
    ref = jax_wkv6(*map(jnp.asarray, (r, k, v, logw, u)), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)
    ref_out, _ = ref_wkv6(*map(torch.tensor, (r, k, v, logw, u)))
    assert torch.equal(out, ref_out)


def test_wkv6_refuses_bad_operands():
    x = torch.zeros((2, 20, 16))
    with pytest.raises(ValueError, match="multiple of CHUNK"):
        wkv6(x, x, x, x, torch.zeros((2, 16)))
    y = torch.zeros((2, 16, 16))
    with pytest.raises(ValueError, match="dtype"):
        wkv6(y, y, y.double(), y, torch.zeros((2, 16)))


# --------------------------------------------------------- flash attention
@pytest.mark.parametrize("S,hd,causal,window",
                         [(128, 64, True, 0), (256, 64, True, 64),
                          (256, 128, False, 0), (384, 32, True, 128)])
def test_flash_attention_sweep(rng, S, hd, causal, window):
    q, k, v = (rng.standard_normal((2, S, hd)).astype(np.float32)
               for _ in range(3))
    before = flash_attention.launches
    out = flash_attention(*(torch.tensor(a)[:, :, None] for a in (q, k, v)),
                          causal=causal, window=window)[:, :, 0]
    assert flash_attention.launches == before
    pallas = jax_flash(*map(jnp.asarray, (q, k, v)), causal=causal,
                       window=window, interpret=True)
    ref = jax_ref_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                            window=window)
    for other in (pallas, ref):
        np.testing.assert_allclose(out.numpy(), np.asarray(other),
                                   rtol=2e-4, atol=2e-5)


def test_flash_attention_bf16(rng):
    q, k, v = (rng.standard_normal((1, 128, 1, 64)) for _ in range(3))
    out = flash_attention(*(torch.tensor(a, dtype=torch.bfloat16)
                            for a in (q, k, v)))
    assert out.dtype == torch.bfloat16
    ref = jax_ref_attention(*(jnp.asarray(a[:, :, 0], jnp.float32)
                              for a in (q, k, v)))
    np.testing.assert_allclose(out[:, :, 0].float().numpy(), np.asarray(ref),
                               rtol=0.05, atol=0.05)


@pytest.mark.parametrize("S,H,KV,window", [(100, 8, 2, 0), (100, 8, 2, 24),
                                           (40, 4, 1, 16)])
def test_gqa_flash_attention_unpadded(rng, S, H, KV, window):
    q = rng.standard_normal((2, S, H, 32)).astype(np.float32)
    k = rng.standard_normal((2, S, KV, 32)).astype(np.float32)
    v = rng.standard_normal((2, S, KV, 32)).astype(np.float32)
    out = gqa_flash_attention(*map(torch.tensor, (q, k, v)), window=window)
    assert out.shape == q.shape
    pallas = jax_gqa(*map(jnp.asarray, (q, k, v)), window=window,
                     interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), rtol=2e-4,
                               atol=2e-5)
    # the same against the oracle with the KV heads repeated by hand
    G = H // KV
    flat = [torch.tensor(_flat(a)) for a in
            (q, np.repeat(k, G, 2), np.repeat(v, G, 2))]
    ref = ref_attention(*(t[:, :, None] for t in flat), window=window)
    ref = ref[:, :, 0].reshape(2, H, S, 32).transpose(1, 2)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_flash_attention_refuses_bad_operands():
    q = torch.zeros((1, 128, 4, 32))
    with pytest.raises(ValueError, match="multiples"):
        flash_attention(q[:, :100].contiguous(), q, q)
    with pytest.raises(ValueError, match="key/value heads"):
        flash_attention(q, q[:, :, :3].contiguous(), q[:, :, :3].contiguous())
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q, q.double(), q)
