"""The collectives over a tuple of mesh axes and the MoE layers where the
batch lies over ("pod", "data") (`repro_torch.sharding.placement`,
`repro_torch.nn.moe`), on a ("pod", "data", "model") mesh of 2 x 2 x 2
CPU positions, the layout of the 2 x 16 x 16 production mesh.

`all_gather`, `all_reduce_sum`, `reduce_scatter`, `all_to_all` and
`relayout` take a dim whose entry is a tuple of axes, the first major (as
`logical.NamedSharding` lays its blocks out): against a plain
concatenation, a plain f32 sum in axis order and the global tensor, bit
for bit. dbrx-132b and grok-1-314b at `smoke()` size in f32, batch 4 over
("pod", "data"), both FSDP paths (the tokens moved over "data" alone, the
experts' d axis; `moe.GATHER_WEIGHTS_AT` 0 gathers the weights): prefill
and decode against the unplaced port at rtol = atol = 5e-5, the aux loss
likewise, the drops equal, two runs bitwise."""
import pytest
import torch

from repro_torch.configs import ARCHS, smoke
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import decoder_lm as M
from repro_torch.nn import moe
from repro_torch.sharding import NamedSharding, use_mesh
from repro_torch.sharding import placement as pl
from repro_torch.sharding.logical import P

PORT = dict(rtol=5e-5, atol=5e-5)
AXES = {"pod": 2, "data": 2, "model": 2}
BATCH = ("pod", "data")


def _mesh():
    return make_mesh(("cpu",) * 8, AXES)


def _placed(x, *entries):
    mesh = _mesh()
    return pl.shard(x, NamedSharding(mesh, P(*entries)))


def _x(*shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


# ------------------------------------------------------------ collectives
@pytest.mark.parametrize("axis,entry", [(BATCH, None), ("data", "pod")])
def test_all_gather_over_a_tuple(axis, entry):
    """Gathering the batch's axes (or its minor axis alone) concatenates
    the blocks in the order the dim was split: the global tensor, or its
    "pod" block on each position."""
    x = _x(8, 6, 4)
    st = _placed(x, BATCH, None, "model")
    with use_mesh(st.mesh) as scope:
        out = pl.all_gather(st, axis)
    assert out.spec == P(entry, None, "model")
    for i, b in enumerate(out.locals):
        assert torch.equal(b, x[out.sharding.index(pl._coords(st.mesh)[i],
                                                   x.shape)])
    assert scope.exchange["all_gather"]["copies"] > 0


def test_all_gather_refuses_a_major_axis_alone():
    """"pod" is the major axis of ("pod", "data"): gathering it alone
    would not give a block of the dim, so it raises."""
    st = _placed(_x(8, 4), BATCH, None)
    with pytest.raises(NotImplementedError, match="minor axes"):
        pl.all_gather(st, "pod")


def test_all_reduce_sum_over_a_tuple():
    """Partial sums over ("pod", "data"): every position adds its group's
    four blocks in f32 in axis order and rounds once, the same bits as a
    plain sum in that order, on every position."""
    mesh = _mesh()
    parts = [_x(3, 5, seed=i).to(torch.bfloat16) for i in range(8)]
    st = pl.wrap(parts, (None, "model"), mesh)
    out = pl.all_reduce_sum(st, BATCH)
    coords = pl._coords(mesh)
    for i, b in enumerate(out.locals):
        group = [j for j, c in enumerate(coords)
                 if c["model"] == coords[i]["model"]]
        acc = parts[group[0]].float()
        for j in group[1:]:
            acc = acc + parts[j].float()
        assert torch.equal(b, acc.to(torch.bfloat16)), i
    assert pl.all_reduce_sum(st, None) is st


def test_reduce_scatter_over_a_tuple_is_the_all_reduce_slice():
    """`reduce_scatter` over ("pod", "data") onto dim 0 leaves each
    position its block of `all_reduce_sum`'s result, bit for bit."""
    mesh = _mesh()
    st = pl.wrap([_x(8, 3, seed=i) for i in range(8)], (None, "model"), mesh)
    full = pl.all_reduce_sum(st, BATCH)
    out = pl.reduce_scatter(st, BATCH, 0)
    assert out.spec == P(BATCH, "model")
    for i, b in enumerate(out.locals):
        start, size = out.block(i, 0)
        assert torch.equal(b, full.locals[i][start:start + size])


@pytest.mark.parametrize("src,dst", [
    ((BATCH, None, None), ("pod", None, "data")),
    ((BATCH, None, None), (None, None, None)),
    ((None, None, "data"), (BATCH, None, None)),
    ((BATCH, None, "model"), ("model", None, BATCH)),
    (("pod", None, "data"), (None, BATCH, None)),
    ((None, BATCH, None), (None, "pod", "data")),
])
def test_relayout_with_tuple_entries(src, dst):
    """Any layout to any other, tuple entries on either side: every
    position's block is the global tensor's block of the target layout."""
    x = _x(8, 8, 8)
    st = _placed(x, *src)
    with use_mesh(st.mesh):
        out = pl.relayout(st, dst)
    assert out.spec == P(*dst)
    coords = pl._coords(st.mesh)
    for i, b in enumerate(out.locals):
        assert torch.equal(b, x[out.sharding.index(coords[i], x.shape)])


def test_all_to_all_moves_a_minor_axis_onto_a_split_dim():
    """"data" leaves ("pod", "data") and joins dim 1 as its minor axis
    after "model", one exchange."""
    x = _x(8, 8)
    st = _placed(x, BATCH, "model")
    with use_mesh(st.mesh) as scope:
        out = pl.all_to_all(st, "data", 1)
    assert out.spec == P("pod", ("model", "data"))
    coords = pl._coords(st.mesh)
    for i, b in enumerate(out.locals):
        assert torch.equal(b, x[out.sharding.index(coords[i], x.shape)])
    assert scope.exchange["all_to_all"]["calls"] == 1


# ------------------------------------------------------------------- MoE
def _moe_run(cfg, params, toks, n=3):
    """prefill + n greedy decode steps: (logits, aux of the forward,
    drops of every MoE call)."""
    moe.apply_moe.drops = []
    try:
        fwd, aux = M.forward(cfg, params, toks)
        last, cache = M.prefill_step(cfg, params, toks, length=32)
        out = [fwd, last]
        tok = last.argmax(-1, keepdim=True)
        for t in range(n):
            lg, cache = M.decode_step(cfg, params, cache, tok,
                                      toks.shape[1] + t)
            out.append(lg[:, 0])
            tok = lg[:, 0].argmax(-1, keepdim=True)
        drops = [int(d) for d, _ in moe.apply_moe.drops]
    finally:
        moe.apply_moe.drops = None
    return out, aux, drops


@pytest.mark.parametrize("gather_at", [moe.GATHER_WEIGHTS_AT, 0],
                         ids=["move-tokens", "gather-weights"])
@pytest.mark.parametrize("arch", ["dbrx-132b", "grok-1-314b"])
def test_moe_on_pod_data_model(arch, gather_at, monkeypatch):
    """The MoE configs with the batch over ("pod", "data"): the same
    logits, aux loss and drops as the unplaced port, and two runs give
    the same bits."""
    monkeypatch.setattr(moe, "GATHER_WEIGHTS_AT", gather_at)
    cfg = smoke(ARCHS[arch])
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (4, 24),
                         generator=torch.Generator().manual_seed(1))
    want, aux0, drops0 = _moe_run(cfg, model, toks)
    mesh = _mesh()
    params = pl.shard_params(model, mesh)
    assert params["layers"][0]["moe"]["w_gate"].spec == P(None, "data",
                                                          "model")
    with use_mesh(mesh) as scope:
        got, aux, drops = _moe_run(cfg, params, toks)
        again, _, _ = _moe_run(cfg, params, toks)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **PORT)
    torch.testing.assert_close(aux, aux0, **PORT)
    assert drops == drops0
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    op = "reduce_scatter" if gather_at == 0 else "all_to_all"
    assert scope.exchange[op]["copies"] > 0
