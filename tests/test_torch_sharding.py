"""The port's logical-axis system and the LM's spec trees against the JAX
package (`repro.sharding.logical`, `param_specs`, `cache_specs`,
`input_shardings`, `input_specs`), on the CPU; and the placed tensors
and collectives of `repro_torch.sharding.placement`.

The rules, `spec`, `resolve`, `fit_spec` and the shard shapes of `named`
are compared on the production mesh shapes (4, 4), (16, 16) and
(2, 16, 16): the JAX package gets a `Mesh` of the one CPU device
repeated, the port a plain {axis: size} mapping. The spec trees of all
ten configs are compared at full size without allocating anything: the
port keeps its layers in depth order, so layer l * len(pattern) + i (and
encoder layer l) is compared with the reference's stacked leaf at index
l, whose spec has one more leading entry ("layers") and whose shape one
more leading dim. Everything here is exact (no tolerance)."""
import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import Mesh, NamedSharding as JaxNamedSharding

from repro.common import INPUT_SHAPES as JAX_SHAPES
from repro.configs import (ARCHS as JAX_ARCHS, input_shardings as jax_inputs,
                           input_specs as jax_input_specs)
from repro.models import decoder_lm as JM
from repro.nn.attention import attn_defs as jax_attn_defs
from repro.nn.params import tree_bytes as jax_tree_bytes
from repro.sharding import logical as JL
from repro_torch.common import INPUT_SHAPES
from repro_torch.configs import ARCHS, input_shardings, input_specs
from repro_torch.launch.mesh import make_debug_mesh, make_mesh
from repro_torch.models import decoder_lm as M
from repro_torch.nn.attention import attn_defs
from repro_torch.nn.params import tree_bytes
from repro_torch.sharding import logical as L
from repro_torch.sharding import placement as pl

SETTINGS = dict(max_examples=40, deadline=None)
MESHES = {(4, 4): ("data", "model"), (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}
_JAX_MESHES = {}


def _meshes(shape):
    """(the JAX package's Mesh, the port's {axis: size}) of one shape."""
    names = MESHES[shape]
    if shape not in _JAX_MESHES:
        devs = np.array(jax.devices() * int(np.prod(shape)))
        _JAX_MESHES[shape] = Mesh(devs[:int(np.prod(shape))].reshape(shape),
                                  names)
    return _JAX_MESHES[shape], dict(zip(names, shape))


def _t(s):
    """A spec (either package's) as a plain tuple."""
    return tuple(s)


ENTRIES = [None, "data", "model", ("data", "model"), "pod",
           ("pod", "data"), "__frozen__"]
DIMS = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 100, 256]
LOGICAL = [None] + sorted(JL.DEFAULT_RULES)


def test_default_rules_equal_the_reference():
    assert L.DEFAULT_RULES == JL.DEFAULT_RULES


@given(st.lists(st.sampled_from(LOGICAL), min_size=0, max_size=5),
       st.sampled_from([None, *MESHES]))
@settings(**SETTINGS)
def test_spec_matches_reference(names, shape):
    if shape is None:
        assert _t(L.spec(*names)) == _t(JL.spec(*names))
        return
    jm, pm = _meshes(shape)
    assert _t(L.spec(*names, mesh=pm)) == _t(JL.spec(*names, mesh=jm))
    s = JL.spec(*names)
    assert _t(L.resolve(L.P(*s), pm)) == _t(JL.resolve(s, jm))


@given(st.lists(st.sampled_from(ENTRIES), min_size=1, max_size=4),
       st.lists(st.sampled_from(DIMS), min_size=1, max_size=4),
       st.sampled_from(list(MESHES)), st.booleans())
@settings(**SETTINGS)
def test_fit_spec_and_named_match_reference(entries, dims, shape, fallback):
    """The hypothesis test of `tests/test_property.py` on both packages:
    the same fitted spec, and it divides the shape, as the reference's
    `NamedSharding.shard_shape` says."""
    n = min(len(entries), len(dims))
    entries, dims = entries[:n], tuple(dims[:n])
    jm, pm = _meshes(shape)
    used = [a for e in entries for a in L.entry_axes(e)]
    if len(used) != len(set(used)):           # an axis twice: not a spec
        return
    want = JL.fit_spec(JL.P(*entries), dims, jm, fallback=fallback)
    got = L.fit_spec(L.P(*entries), dims, pm, fallback=fallback)
    assert _t(got) == _t(want)
    if fallback:
        jns = JaxNamedSharding(jm, JL.fit_spec(JL.P(*entries), dims, jm))
        assert L.named(pm, L.P(*entries), dims).shard_shape(dims) == \
            tuple(jns.shard_shape(dims))


@pytest.mark.parametrize("shape", list(MESHES))
def test_fit_spec_frozen_layers_dim(shape):
    """The stacked layers dim never receives a fallback axis
    (`tests/test_property.py::test_fit_spec_frozen_layers_dim`)."""
    jm, pm = _meshes(shape)
    s = ("layers", "batch", "heads", None)
    got = L.fit_spec(L.spec(*s), (32, 6, 40, 64), pm)
    assert got[0] is None
    assert _t(got) == _t(JL.fit_spec(JL.spec(*s), (32, 6, 40, 64), jm))


# ------------------------------------------------------------- spec trees
def _pairs(cfg, port, ref):
    """(where, port leaf, reference leaf, stacked) over a port tree of
    `model_defs`' layout and the reference's of its own."""
    P, R = len(cfg.pattern), cfg.pattern_repeats

    def walk(where, a, b, stacked):
        if isinstance(a, dict):
            assert set(a) == set(b), (where, sorted(a), sorted(b))
            for k in a:
                yield from walk(f"{where}.{k}", a[k], b[k], stacked)
        else:
            yield where, a, b, stacked

    for k in port:
        if k == "layers":
            assert len(port[k]) == cfg.num_layers
            for i, layer in enumerate(port[k]):
                if i < P * R:
                    yield from walk(f"layers[{i}]", layer,
                                    ref["blocks"][i % P], True)
                else:
                    yield from walk(f"layers[{i}]", layer,
                                    ref["rem"][i - P * R], False)
        elif k == "encoder":
            for i, layer in enumerate(port[k]):
                yield from walk(f"encoder[{i}]", layer, ref["encoder"], True)
        else:
            yield from walk(k, port[k], ref[k], False)
    assert set(port) - {"layers"} == set(ref) - {"blocks", "rem"}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_and_abstract_params_match_reference(arch):
    cfg, jcfg = ARCHS[arch], JAX_ARCHS[arch]
    n = 0
    for where, got, want, stacked in _pairs(cfg, M.param_specs(cfg),
                                            JM.param_specs(jcfg)):
        want = _t(want)
        if stacked:
            assert want[0] == "__frozen__", where
            want = want[1:]
        assert _t(got) == want, (where, got, want)
        n += 1
    assert n > 0
    for where, got, want, stacked in _pairs(cfg, M.abstract_params(cfg),
                                            JM.abstract_params(jcfg)):
        assert got.device.type == "meta", where
        assert tuple(got.shape) == tuple(want.shape)[int(stacked):], where
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    assert tree_bytes(M.abstract_params(cfg)) == \
        jax_tree_bytes(JM.abstract_params(jcfg))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_match_reference(arch):
    cfg, jcfg = ARCHS[arch], JAX_ARCHS[arch]
    got, want = M.cache_specs(cfg, 2, 16), JM.cache_specs(jcfg, 2, 16)
    ab, jab = M.abstract_cache(cfg, 2, 16), JM.abstract_cache(jcfg, 2, 16)
    P, R = len(cfg.pattern), cfg.pattern_repeats
    assert len(got) == cfg.num_layers
    for i, (c, a) in enumerate(zip(got, ab)):
        stacked = i < P * R
        w = want["blocks"][i % P] if stacked else want["rem"][i - P * R]
        ja = jab["blocks"][i % P] if stacked else jab["rem"][i - P * R]
        assert set(c) == set(w), (i, sorted(c), sorted(w))
        for n in c:
            ws = _t(w[n])[1:] if stacked else _t(w[n])
            assert _t(c[n]) == ws, (i, n, c[n], ws)
            assert tuple(a[n].shape) == tuple(ja[n].shape)[int(stacked):]
            assert str(a[n].dtype).removeprefix("torch.") == \
                str(ja[n].dtype)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_and_shardings_match_reference(arch):
    cfg, jcfg = ARCHS[arch], JAX_ARCHS[arch]
    for name, shape in INPUT_SHAPES.items():
        got = input_specs(cfg, shape)
        want = jax_input_specs(jcfg, JAX_SHAPES[name])
        assert set(got) == set(want)
        for k in got:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(want[k].shape)
            assert str(got[k].dtype).removeprefix("torch.") == \
                str(want[k].dtype)
        gs, ws = input_shardings(cfg, shape), jax_inputs(jcfg,
                                                         JAX_SHAPES[name])
        assert {k: _t(v) for k, v in gs.items()} == \
            {k: _t(v) for k, v in ws.items()}


@pytest.mark.parametrize("arch", ["mistral-large-123b", "granite-34b",
                                  "gemma-7b"])
def test_attn_defs_shard_kv_over_head_dim_as_the_reference(arch):
    """wk / wv take `cache_hd` where the KV heads do not divide 16 but the
    query heads and the head dim do (mistral-large-123b: 96 / 8 heads of
    128), the layout of the KV cache; otherwise `kv_heads`."""
    got = attn_defs(ARCHS[arch])
    want = jax_attn_defs(JAX_ARCHS[arch])
    for k in want:
        assert got[k].shape == want[k].shape
        assert got[k].logical == want[k].logical, (k, got[k].logical)
    if arch != "gemma-7b":
        assert got["wk"].logical == ("embed", None, "cache_hd")


@pytest.mark.parametrize("model", [4, 8])
def test_per_position_bytes_of_the_full_model(model):
    """Per-position parameter bytes of mistral-large-123b at full depth,
    from the fitted shard shapes (what `chip_smoke.py` prints as the
    analytic capacity): the reference's `NamedSharding` shard shapes give
    the same bytes, and model positions split all but the norms."""
    cfg, jcfg = ARCHS["mistral-large-123b"], JAX_ARCHS["mistral-large-123b"]
    pm = {"data": 1, "model": model}
    jm = Mesh(np.array(jax.devices() * model).reshape(1, model),
              ("data", "model"))
    specs, ab = M.param_specs(cfg), M.abstract_params(cfg)
    got = tree_bytes(pl.abstract_placed(ab, specs, pm))
    jspecs, jab = JM.param_specs(jcfg), JM.abstract_params(jcfg)
    want = sum(int(np.prod(JaxNamedSharding(
        jm, JL.fit_spec(s, a.shape, jm)).shard_shape(a.shape)))
        * a.dtype.itemsize for s, a in zip(jax.tree.leaves(jspecs),
                                           jax.tree.leaves(jab)))
    assert got == want
    total = tree_bytes(ab)
    norms = 2 * cfg.d_model * (2 * cfg.num_layers + 1)
    assert got == (total - norms) // model + norms


# -------------------------------------------------------------- placement
def _cpu_mesh(data, model):
    return make_mesh(("cpu",) * (data * model), {"data": data,
                                                 "model": model})


@pytest.mark.parametrize("data,model", [(1, 2), (1, 4), (2, 1), (2, 2)])
@pytest.mark.parametrize("logical", [("batch", None, "heads", None),
                                     ("batch", None, None, "cache_hd"),
                                     (None, "vocab", None, None),
                                     ("batch", None, None, None)])
def test_shard_gather_and_collectives(data, model, logical):
    mesh = _cpu_mesh(data, model)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 8, 8, 16)).astype(np.float32))
    st_ = pl.shard(x, L.named(mesh, L.spec(*logical), x.shape))
    assert all(b.shape == st_.sharding.shard_shape(x.shape)
               for b in st_.locals)
    assert torch.equal(pl.gather(st_), x)
    with L.use_mesh(mesh) as scope:
        for target in [("data", None, "model", None),
                       ("data", None, None, "model"), ("data",),
                       (None, "model")]:
            moved = pl.relayout(st_, L.P(*target))
            assert list(moved.spec) == list(target) + [None] * (
                4 - len(target))
            assert torch.equal(pl.gather(moved), x)
    assert set(scope.exchange) <= {"all_gather", "all_to_all", "gather"}
    assert all(s["copies"] > 0 and s["bytes"] > 0
               for s in scope.exchange.values())
    if model > 1 and logical[2] == "heads":   # heads -> head dim
        with L.use_mesh(mesh) as scope:
            pl.all_to_all(st_, "model", 3)
        local = x.numel() * 4 // (data * model)
        assert scope.exchange["all_to_all"] == {
            "calls": 1, "copies": data * model * (model - 1),
            "bytes": data * model * (model - 1) * local // model}
    # partial sums: every position a term; the sum rounds once, in f32
    terms = pl.local_map(lambda b: b.to(torch.bfloat16), st_,
                         spec=L.P("data"))
    red = pl.all_reduce_sum(pl.wrap(terms.locals, L.P("data"), mesh),
                            "model")
    for g in pl._groups(mesh, "model"):
        want = sum(terms.locals[j].float() for j in g).to(torch.bfloat16)
        assert all(torch.equal(red.locals[i], want) for i in g)


def test_einsum_row_parallel_equals_the_product():
    mesh = _cpu_mesh(2, 2)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 5, 8, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 16, 32)).astype(np.float32))
    xs = pl.shard(x, L.named(mesh, L.spec("batch", None, "heads", None),
                             x.shape))
    ws = pl.shard(w, L.named(mesh, L.spec("heads", "head_dim", "embed"),
                             w.shape))
    with L.use_mesh(mesh) as scope:
        out = pl.einsum("bshe,hed->bsd", xs, ws)
    assert list(out.spec) == ["data", None, None]
    torch.testing.assert_close(pl.gather(out), torch.einsum(
        "bshe,hed->bsd", x, w), rtol=1e-5, atol=1e-5)
    s = scope.exchange["all_reduce_sum"]
    assert s["calls"] == 1 and s["copies"] == 4
    assert s["bytes"] == 4 * 2 * 5 * 32 * 4


def test_constrain_is_a_noop_outside_a_mesh_and_on_one_position():
    x = torch.ones(4, 8)
    assert L.constrain(x, "batch", "embed") is x
    with L.use_mesh(make_debug_mesh(devices=("cpu",))):
        assert L.constrain(x, "batch", "embed") is x
    mesh = _cpu_mesh(2, 2)
    with L.use_mesh(mesh):
        q = L.constrain(torch.arange(4 * 1 * 8 * 16.).reshape(4, 1, 8, 16),
                        "batch", "rep", "heads", None)
        assert list(q.spec) == ["data", None, "model", None]
        moved = L.constrain(q, "batch", "rep", "rep", "cache_hd")
        assert list(moved.spec) == ["data", None, None, "model"]
        assert torch.equal(pl.gather(moved), pl.gather(q))


def test_make_debug_mesh():
    m = make_debug_mesh(devices=("cpu",) * 4)
    assert m.axis_names == ("data", "model") and m.dims == (1, 4)
    with pytest.raises(ValueError):
        make_debug_mesh(8 + torch.cuda.device_count())


def test_a_fallback_placement_raises():
    """granite-34b at smoke size: one KV head and 4 query heads, so wk and
    wv stay on `kv_heads` and fit_spec moves the model axis to d, their
    contracting dim, a layout the layers run. rwkv6-3b's 2 heads at
    model 4: its state cache takes the axis on its key dim, which its
    decode step runs too (`placement.FALLBACK_DIMS`). A fallback no layer
    runs still raises: a KV cache of 3 heads at model 4, whose axis would
    go to its sequence dim."""
    from repro_torch.configs import smoke
    cfg = smoke(ARCHS["granite-34b"])
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params = pl.shard_params(model, _cpu_mesh(1, 2))
    for w in ("wk", "wv"):
        assert params["layers"][0]["attn"][w].spec == L.P("model", None,
                                                          None)
    assert params["layers"][0]["attn"]["wq"].spec == L.P(None, "model",
                                                         None)
    pl.shard_params(model, _cpu_mesh(2, 1))          # data only: fine
    rwkv = smoke(ARCHS["rwkv6-3b"])
    cache = M.init_cache(rwkv, 2, 8, "cpu")
    placed = pl.shard_cache(rwkv, cache, _cpu_mesh(1, 4))
    assert placed[0]["state"].spec == L.P("data", None, "model", None)
    assert torch.equal(pl.gather(placed[0]["state"]), cache[0]["state"])
    kv = L.spec("batch", "cache_seq", "kv_heads", None)
    assert L.fit_spec(kv, (2, 8, 3, 32), {"data": 1, "model": 4}) == \
        L.P("data", "model", None, None)
    with pytest.raises(NotImplementedError, match="fallback.*no layer runs"):
        pl.shard(torch.zeros((2, 8, 3, 32)), L.NamedSharding(
            _cpu_mesh(1, 4), pl.fitted(kv, (2, 8, 3, 32), _cpu_mesh(1, 4),
                                       ("batch", "cache_seq", "kv_heads",
                                        None))))
