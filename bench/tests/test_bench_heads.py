"""Head architectures by file (`bench/heads/`): the draw, the reference's
logits and the counted work of `sgc` and the repo's `gamlp` equal what the
harness computed before they moved there, and a new architecture is one
new file."""
import ast
import hashlib
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import graphgen, harness, heads
from bench.metrics import _counting as cnt
from bench.reference import nai as ref

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 77
GCFGS = {
    "sgc-1": dict(base_model="sgc", feat_dim=12, num_classes=5, k=3, r=0.5,
                  mlp_layers=1),
    "sgc-2": dict(base_model="sgc", feat_dim=12, num_classes=5, k=3, r=0.5,
                  hidden=7, mlp_layers=2),
    "gamlp": dict(base_model="gamlp", feat_dim=12, num_classes=5, k=3,
                  r=0.5, hidden=7, mlp_layers=2, att_dim=6),
}


# ---------------------------------------------- the arithmetic as it was
def _old_layer_dims(model, f, classes, hidden, mlp_layers):
    if model not in ("sgc", "gamlp"):
        raise ValueError(model)
    return [f] + [hidden] * (mlp_layers - 1) + [classes]


def _old_make_heads(gcfg, seed, device):
    shapes = []
    dims = _old_layer_dims(gcfg["base_model"], gcfg["feat_dim"],
                           gcfg["num_classes"], gcfg.get("hidden"),
                           gcfg["mlp_layers"])
    for l in range(1, gcfg["k"] + 1):
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            shapes.append((l, f"w{i}", (a, b), 1.0 / math.sqrt(a)))
            shapes.append((l, f"b{i}", (b,), 0.0))
        if gcfg["base_model"] == "gamlp":
            shapes.append((l, "att_w", (gcfg["feat_dim"], gcfg["att_dim"]),
                           0.02))
            shapes.append((l, "att_v", (gcfg["att_dim"],), 0.02))
    total = sum(int(np.prod(s)) for _, _, s, _ in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32).cpu().numpy()
    tree = {}
    off = 0
    for l, key, shape, scale in shapes:
        n = int(np.prod(shape))
        tree.setdefault(l, {})[key] = (flat[off:off + n].reshape(shape)
                                       * np.float32(scale))
        off += n
    return tree


def _old_head_logits(model, p, series, l, emulate_tf32=False):
    def mm(a, w):
        return ref._tf32(a) @ ref._tf32(w) if emulate_tf32 else a @ w
    sub = series[:l + 1]
    if model == "sgc":
        h = sub[l]
    elif model == "gamlp":
        L, N, f = sub.shape
        scores = torch.tanh(mm(sub.reshape(L * N, f), p["att_w"]))
        att = mm(scores, p["att_v"][:, None]).reshape(L, N)
        h = (torch.softmax(att, dim=0)[..., None] * sub).sum(dim=0)
    else:
        raise ValueError(model)
    n_layers = sum(1 for k in p if k.startswith("w"))
    for i in range(n_layers):
        h = mm(h, p[f"w{i}"]) + p[f"b{i}"]
        if i < n_layers - 1:
            h = torch.relu(h)
    return h


def _old_head_flops(model, dims, f, att_dim, orders):
    total = 0.0
    mlp = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    for l, n in zip(*np.unique(np.asarray(orders), return_counts=True)):
        macs = mlp
        if model == "gamlp":
            macs += (l + 1) * (f * att_dim + att_dim + f)
        total += 2.0 * int(n) * macs
    return total


def _old_count_needs(built, batches):
    """The count as it read the program's `GNNConfig`."""
    cfg, nai, peak = built["cfg"], built["nai"], built["peak"]
    dims = _old_layer_dims(cfg.base_model, cfg.feat_dim, cfg.num_classes,
                           cfg.hidden, cfg.mlp_layers)
    flops = bytes_ = step_time = head = 0.0
    for rs in batches.values():
        uniq, orders, _ = harness.answers(rs)
        head += _old_head_flops(cfg.base_model, dims, cfg.feat_dim,
                                cfg.att_dim, orders)
        for s in cnt.step_needs(built["eg"], uniq, orders, cfg.feat_dim,
                                nai.t_min, nai.t_max):
            flops += s.flops
            bytes_ += s.bytes
            step_time += cnt.roofline_s(s.flops, s.bytes, peak["f32_flops"],
                                        peak["hbm_bytes_per_s"])
    return dict(step_flops=flops, step_bytes=bytes_, step_roofline_s=step_time,
                head_flops=head)


# ------------------------------------------------------------ the draw
@pytest.mark.parametrize("name", sorted(GCFGS))
def test_make_heads_is_byte_equal_to_the_parents(name):
    gcfg = GCFGS[name]
    new = harness.make_heads(gcfg, SEED, "cpu")
    old = _old_make_heads(gcfg, SEED, "cpu")
    assert sorted(new) == sorted(old) == [1, 2, 3]
    for l in old:
        assert list(new[l]) == list(old[l])
        for key, a in old[l].items():
            b = new[l][key]
            assert (a.dtype, a.shape) == (b.dtype, b.shape), key
            assert a.tobytes() == b.tobytes(), (l, key)


# ---------------------------------------------------- the reference
def _series(f, n, dtype, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(4, n, f, generator=g, dtype=torch.float64).to(dtype)


@pytest.mark.parametrize("tf32", [False, True], ids=["float64", "tf32"])
@pytest.mark.parametrize("name", sorted(GCFGS))
def test_logits_are_bit_equal_to_the_parents(name, tf32):
    gcfg = GCFGS[name]
    dtype = torch.float32 if tf32 else torch.float64
    tree = harness.make_heads(gcfg, SEED, "cpu")
    series = _series(gcfg["feat_dim"], 33, dtype)
    mod = heads.load(gcfg["base_model"])
    mm = ref.matmul_tf32 if tf32 else torch.matmul
    for l in range(1, gcfg["k"] + 1):
        p = {k: torch.as_tensor(v).to(dtype) for k, v in tree[l].items()}
        new = mod.logits(p, series, l, mm)
        old = _old_head_logits(gcfg["base_model"], p, series, l, tf32)
        assert new.dtype == dtype and torch.equal(new, old), l


@pytest.mark.parametrize("tf32", [False, True], ids=["float64", "tf32"])
@pytest.mark.parametrize("model", ["sgc", "gamlp"])
def test_reference_batch_logits_are_bit_equal_to_the_parents(model, tf32):
    """Through `Reference.batch`: the product it hands the head module is
    the one the parent's reference took (TF32 emulated on the CPU)."""
    ga = graphgen.make_sbm("arxiv-like", scale=0.01, seed=4)
    gcfg = dict(GCFGS["gamlp" if model == "gamlp" else "sgc-2"],
                feat_dim=ga.features.shape[1], num_classes=ga.num_classes)
    tree = harness.make_heads(gcfg, SEED, "cpu")
    eg = ref.EdgeGraph(ga.n, ga.src, ga.dst)
    dtype = torch.float32 if tf32 else torch.float64
    r = ref.Reference(eg, ga.features, tree, logits=heads.load(model).logits,
                      r=0.5, t_min=1, t_max=2, t_s=1.0, dtype=dtype,
                      tf32=tf32)
    batch = np.sort(ga.test_idx[:40])
    out = r.batch(batch)
    ser = r.series[:, torch.as_tensor(batch)]
    with torch.inference_mode():
        for l in (1, 2):
            old = _old_head_logits(model, r.heads[l], ser, l, tf32)
            assert np.array_equal(out.logits[l - 1],
                                  old.numpy().astype(np.float64)), l


# ---------------------------------------------------------- the count
def _tiny(gnn=None):
    cell = harness.load_cell("arxiv-sgc.seg500")
    cell["config"]["graph"]["scale"] = 0.02
    cell["mix"]["batch"] = 32
    if gnn is not None:
        cell["config"]["gnn"] = dict(cell["config"]["gnn"], **gnn)
    return cell


def _run_counted(cell, monkeypatch):
    """A traced CPU dry run of `cell`, with what `count_needs` was given
    and gave."""
    seen = []
    count = harness.count_needs

    def counted(built, batches):
        out = count(built, batches)
        seen.append((built, batches, out))
        return out
    monkeypatch.setattr(harness, "count_needs", counted)
    out = harness.run_cell(cell, SEED, 0.5, True, device="cpu",
                           log=lambda s: None)
    assert len(seen) == 1 and "nai_mfu" in out["metrics"]
    return out, seen[0]


@pytest.mark.parametrize("gnn", [None, dict(base_model="gamlp", hidden=16,
                                            mlp_layers=2, att_dim=8)],
                         ids=["arxiv-sgc", "gamlp"])
def test_count_needs_equals_the_parents(gnn, monkeypatch):
    out, (built, batches, needs) = _run_counted(_tiny(gnn), monkeypatch)
    assert out["correct"] is True and batches
    assert needs == _old_count_needs(built, batches)
    assert needs["head_flops"] > 0


# ------------------------------------------- a new architecture, one file
TOY = '''"""S2GC-like toy: the mean of X^(0..l), times a constant gain of
ones, then the MLP."""
from bench.heads import mlp, mlp_dims, mlp_draws, mlp_macs


def draws(gcfg):
    f = gcfg["feat_dim"]
    dims = mlp_dims(gcfg, f)
    return [d for l in range(1, gcfg["k"] + 1)
            for d in [(l, "gain", (f,), ("const", 1.0))]
            + mlp_draws(dims, l)]


def logits(p, series, l, mm):
    return mlp(p, series[:l + 1].mean(dim=0) * p["gain"], mm)


def macs(gcfg, l):
    f = gcfg["feat_dim"]
    return mlp_macs(mlp_dims(gcfg, f)) + (l + 2) * f
'''


def _digest(paths):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in paths}


def test_a_head_architecture_is_one_new_file(tmp_path, monkeypatch):
    """`s2gc`, which the program serves and the benchmark had no file for,
    written as one file into a heads directory of its own: drawn (its
    constant taking no draws), referenced and counted through `build` and
    `check`, and the run correct, with no other file touched."""
    bench_files = sorted((ROOT / "bench").rglob("*.py"))
    before = _digest(bench_files)
    (tmp_path / "s2gc.py").write_text(TOY)
    monkeypatch.setattr(heads, "HEADS", tmp_path)
    with pytest.raises(FileNotFoundError):
        heads.load("sgc")
    out, (built, batches, needs) = _run_counted(
        _tiny(dict(base_model="s2gc")), monkeypatch)
    assert out["correct"] is True, out["checks"]
    assert out["compared"] > 0
    gcfg = built["gcfg"]
    f, c = gcfg["feat_dim"], gcfg["num_classes"]
    sgc = _old_make_heads(dict(gcfg, base_model="sgc"), SEED, "cpu")
    for l in (1, 2, 3):
        assert list(built["tree"][l]) == ["gain", "w0", "b0"]
        assert np.array_equal(built["tree"][l]["gain"], np.ones(f))
        for key in ("w0", "b0"):
            assert built["tree"][l][key].tobytes() == sgc[l][key].tobytes()
    want = 0.0
    for rs in batches.values():
        _, orders, _ = harness.answers(rs)
        want += sum(2.0 * (f * c + (int(o) + 2) * f) for o in orders)
    assert needs["head_flops"] == want
    assert _digest(bench_files) == before
    assert sorted((ROOT / "bench").rglob("*.py")) == bench_files


def test_unknown_base_model_names_its_file():
    with pytest.raises(FileNotFoundError,
                       match=r"bench/heads/no_such_head\.py"):
        heads.load("no_such_head")
    with pytest.raises(FileNotFoundError, match="no_such_head"):
        harness.make_heads(dict(GCFGS["sgc-1"], base_model="no_such_head"),
                           SEED, "cpu")


@pytest.mark.parametrize("path", sorted(
    p.name for p in (ROOT / "bench" / "heads").glob("*.py")))
def test_head_modules_import_nothing_of_the_program(path):
    tree = ast.parse((ROOT / "bench" / "heads" / path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
