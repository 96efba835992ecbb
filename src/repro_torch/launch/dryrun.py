"""Multi-pod dry run (`repro.launch.dryrun`): every (architecture x input
shape) on the production meshes, with nothing allocated, its memory a
position and its roofline terms on the H100.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--no-compile]

The reference lowers and compiles each combo for 256 or 512 TPU chips and
reads XLA's memory and cost analysis. The port runs on the CPU with a
mesh of `meta` devices (`make_production_mesh(devices=("meta",) * n)`),
whose blocks have shapes and no memory:

* "lower" (`lower_s`): the parameters, the optimizer state, the cache and
  the inputs placed by their specs at the config's full depth, as `meta`
  blocks a position (`placement.abstract_placed`): the argument and
  output bytes a position; a parameter or cache entry whose fitted spec
  is a layout no layer runs raises here, as placing it would
  (`placement.fitted`);
* "compile" (`compile_s`, skipped with ``--no-compile``): the step of the
  shape's mode (train `build_train_step`, prefill `prefill_step`, decode
  `decode_step`) run on models placed on the mesh of `meta` devices, its
  ops counted by `launch.cost_analysis.analyze`. The layers are a Python
  loop, so instead of the config's depth it runs a model of a few
  repeats of the layer pattern, one of a repeat more, and for an encoder
  one of one encoder layer more, and extrapolates each count linearly
  (`counted_models`); a remainder of the pattern (recurrentgemma's 38 =
  12 x 3 + 2) is in every counted model, so it is counted once.

The record has the reference's keys. `memory` is per position
(`per_chip_gb` = arguments + the counted peak of live bytes, the
reference's arguments + temporaries; the reference divides XLA's
per-device sizes by the chips once more, the port does not), `fits_hbm`
holds it against the H100's 80 GB and `roofline` gives the data-sheet
terms of `launch.roofline` (bf16 peak, HBM, NVLink one way).

Also the train step itself (the reference's `build_train_step`): the
training configuration a model gets, its step, and the optimizer state's
shapes and partition specs.

    step, tc = build_train_step(cfg)
    params = placement.shard_params(model, mesh, trainable=True)
    opt = adamw_init(params, tc)          # moments placed as the params
    with use_mesh(mesh):
        params, opt, metrics = step(params, opt, batch)

The reference jits its step with the parameters and the moments placed by
`param_specs` and `opt_state_specs`; here the step runs eagerly on a
placed tree (`launch.train.lm_train_step`: `loss_fn`, its gradients
summed over the axes each leaf's spec leaves free, the in-place AdamW),
or on a module off a mesh. The reference's `_named_tree` (specs to
`NamedSharding`s) has no counterpart: `abstract_placed` and
`shard_params` fit each spec to its leaf themselves.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.common import (H100_SXM, INPUT_SHAPES, MeshConfig,
                                TrainConfig)
from repro_torch.configs import ARCHS, get_config, input_shardings, input_specs
from repro_torch.launch.cost_analysis import analyze, extrapolate
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.roofline import (active_params, model_flops,
                                         roofline_terms)
from repro_torch.launch.train import lm_train_step
from repro_torch.models import decoder_lm as M
from repro_torch.nn.params import _map_defs, torch_dtype, tree_bytes
from repro_torch.optim import adamw_init, make_schedule
from repro_torch.sharding import use_mesh
from repro_torch.sharding import placement as pl
from repro_torch.sharding.logical import spec as logical_spec

# above this many parameters the Adam moments are kept in bf16
BF16_MOMENTS_ABOVE = 60e9
OUT = "build/dryrun"


def _n_params(cfg) -> int:
    return sum(t.numel() for _, t in pl.named_leaves(M.abstract_params(cfg)))


def _train_cfg(cfg) -> TrainConfig:
    """The reference's defaults, with bf16 Adam moments for a model of
    more than 60e9 parameters and f32 ones otherwise."""
    mdt = "bfloat16" if _n_params(cfg) > BF16_MOMENTS_ABOVE else "float32"
    return TrainConfig(moment_dtype=mdt)


def build_train_step(cfg, **overrides):
    """(train_step, tc): `_train_cfg(cfg)` with `overrides` (TrainConfig
    fields), and train_step(params, opt_state, batch) -> (params,
    opt_state, metrics), which updates `params` (a module, or a placed
    tree inside `use_mesh`) and `opt_state` in place and returns them."""
    tc = dataclasses.replace(_train_cfg(cfg), **overrides)
    sched = make_schedule(tc)

    def train_step(params, opt_state, batch):
        metrics = lm_train_step(cfg, params, opt_state, tc, sched, batch)
        return params, opt_state, metrics

    return train_step, tc


def abstract_opt_state(cfg, tc: TrainConfig):
    """The optimizer state as `meta` tensors: the moments in
    `tc.moment_dtype`, shaped as the parameters (`model_defs`' tree), and
    the int32 step count."""
    mdt = torch_dtype(tc.moment_dtype)

    def moments(t):
        if isinstance(t, dict):
            return {k: moments(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [moments(v) for v in t]
        return torch.empty(t.shape, dtype=mdt, device="meta")
    mom = moments(M.abstract_params(cfg))
    return {"mu": mom, "nu": mom,
            "count": torch.empty((), dtype=torch.int32, device="meta")}


def opt_state_specs(cfg):
    """The optimizer state's partition specs: each moment's is its
    parameter's, the count replicated."""
    ps = M.param_specs(cfg)
    return {"mu": ps, "nu": ps, "count": logical_spec()}


# ---------------------------------------------------------------- dry run
def counted_models(cfg):
    """[(label, weight, config)]: the models whose counts, weighted and
    summed, give the counts of `cfg`, each count being linear in the
    pattern's repeats and in the encoder layers. The decoder is counted
    at b repeats (the fewest that hold every exit head, at least one) and
    b + 1, the encoder at 1 and 2 layers; a config of at most b + 1
    repeats and 2 encoder layers is counted as it is."""
    P, n_rem = len(cfg.pattern), len(cfg.remainder)
    R, E = cfg.pattern_repeats, cfg.encoder_layers
    last_exit = (max(cfg.adaptive.exit_layers) if M.has_exits(cfg)
                 else -1)
    b = max(1, -(-(last_exit + 1 - n_rem) // P))
    r0 = R if R <= b + 1 else b
    e0 = E if E <= 2 else 1

    def variant(r, e):
        return (f"{r} repeats, {e} encoder layers",
                dataclasses.replace(cfg, num_layers=r * P + n_rem,
                                    encoder_layers=e))
    base = variant(r0, e0)
    runs, w0 = [], 1.0
    if r0 != R:
        runs.append((*variant(r0 + 1, e0), float(R - r0)))
        w0 -= R - r0
    if e0 != E:
        runs.append((*variant(r0, e0 + 1), float(E - e0)))
        w0 -= E - e0
    return [(base[0], w0, base[1])] + [(lb, w, c) for lb, c, w in runs]


def _abstract(cfg, shape, axes, tc):
    """(arguments, outputs, updated in place): `meta` blocks a position of
    the step's arguments and outputs at the config's depth, placed by
    their specs on a mesh of `axes`."""
    def placed(tree, specs):
        return pl.abstract_placed(tree, specs, axes)
    B, S = shape.global_batch, shape.seq_len
    params = placed(M.abstract_params(cfg), M.param_specs(cfg))
    inputs = placed(input_specs(cfg, shape), input_shardings(cfg))
    if shape.mode == "train":
        opt = placed(abstract_opt_state(cfg, tc), opt_state_specs(cfg))
        return (params, opt, inputs), (params, opt), (params, opt)
    L = S if shape.mode == "prefill" else M._decode_len(cfg, S)
    cache = placed(M.abstract_cache(cfg, B, L), M.cache_specs(cfg, B, L))
    dt = torch_dtype(cfg.dtype)
    if shape.mode == "prefill":
        logits = placed(torch.empty((B, cfg.vocab_size), dtype=dt,
                                    device="meta"),
                        logical_spec("batch", "vocab"))
        return (params, inputs), (logits, cache), ()
    logits = placed(torch.empty((B, 1, cfg.vocab_size), dtype=dt,
                                device="meta"),
                    logical_spec("batch", None, "vocab"))
    return (params, cache, inputs), (logits, cache), (cache,)


def _check_layouts(cfg, shape, axes) -> None:
    """Raise where a parameter or a cache entry of `cfg` would take a
    layout on a mesh of `axes` that no layer runs: each spec fitted as
    `shard_params` and `init_cache` fit it."""
    _map_defs(lambda d: pl.fitted(logical_spec(*d.logical), d.shape, axes,
                                  d.logical), M.model_defs(cfg))
    if shape.mode != "train":
        B, S = shape.global_batch, shape.seq_len
        L = S if shape.mode == "prefill" else M._decode_len(cfg, S)
        for c in M.abstract_cache(cfg, B, L):
            for name, t in c.items():
                M.fit_cache(cfg, name, t.shape, axes)


def count_step(cfg, shape, mesh, tc):
    """`analyze` of the shape's step on `cfg`, placed on `mesh` (of
    `meta` devices): counts a position."""
    n = len(mesh.devices)
    train = shape.mode == "train"
    params = pl.shard_params(M.DecoderLM(cfg, torch.device("meta")), mesh,
                             trainable=train)
    inputs = input_specs(cfg, shape)
    with use_mesh(mesh):
        if train:
            step, tc_ = build_train_step(cfg, moment_dtype=tc.moment_dtype)
            return analyze(step, params, adamw_init(params, tc_), inputs,
                           positions=n)
        if shape.mode == "prefill":
            return analyze(lambda p, b: M.prefill_step(
                cfg, p, b["tokens"], frontend=b.get("frontend")),
                params, inputs, positions=n)
        L = M._decode_len(cfg, shape.seq_len)
        cache = M.init_cache(cfg, shape.global_batch, L, device="meta")
        return analyze(lambda p, c, b: M.decode_step(
            cfg, p, c, b["tokens"], L - 1), params, cache, inputs,
            positions=n)


def lower_combo(arch: str, shape_name: str, *, multi_pod: bool = False,
                compile_: bool = True, verbose: bool = True, cfg=None,
                shape=None, mesh=None):
    """The record of one combo (or raises). `cfg`, `shape` (a
    `ShapeConfig`) and `mesh` (an {axis: size} mapping) replace the
    arch's config, the named shape and the production mesh, for a
    smaller combo (`chip_smoke.py` sets them to the sizes it measures)."""
    cfg = get_config(arch) if cfg is None else cfg
    shape = INPUT_SHAPES[shape_name] if shape is None else shape
    mc = MeshConfig(multi_pod=multi_pod)
    axes = dict(zip(mc.axes, mc.shape)) if mesh is None else dict(mesh)
    chips = math.prod(axes.values())
    tc = _train_cfg(cfg)
    t0 = time.time()
    _check_layouts(cfg, shape, axes)
    args, outs, alias = _abstract(cfg, shape, axes, tc)
    arg_b, out_b = tree_bytes(args), tree_bytes(outs)
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": ("x".join(map(str, axes.values())) if mesh is not None
                 else "2x16x16" if multi_pod else "16x16"),
        "chips": chips, "mode": shape.mode,
        "lower_s": round(time.time() - t0, 1),
        "memory": {"argument_bytes": arg_b, "output_bytes": out_b,
                   "temp_bytes": None, "generated_code_bytes": None,
                   "alias_bytes": tree_bytes(alias),
                   "per_chip_gb": round(arg_b / 1e9, 3)},
    }
    rec["fits_hbm"] = rec["memory"]["per_chip_gb"] <= H100_SXM.hbm_bytes / 1e9
    if not compile_:
        return rec
    t1 = time.time()
    meta = ("meta",) * chips
    dmesh = (make_mesh(meta, axes) if mesh is not None else
             make_production_mesh(multi_pod=multi_pod, devices=meta))
    runs = [(label, w, count_step(c, shape, dmesh, tc))
            for label, w, c in counted_models(cfg)]
    stats = extrapolate(runs)
    rec["compile_s"] = round(time.time() - t1, 1)

    n_params = _n_params(cfg)
    n_active = active_params(cfg, n_params)
    terms = roofline_terms(stats, chips=chips)
    mf = model_flops(cfg, shape, n_params, n_active)
    terms["model_flops"] = mf
    terms["useful_ratio"] = mf / terms["hlo_flops"] if terms["hlo_flops"] else 0.0
    terms["counted"] = stats.mults
    tmp_b = int(stats.peak_bytes)
    rec.update(params=n_params, active_params=n_active, roofline=terms)
    rec["memory"].update(temp_bytes=tmp_b,
                         per_chip_gb=round((arg_b + tmp_b) / 1e9, 3))
    rec["fits_hbm"] = rec["memory"]["per_chip_gb"] <= H100_SXM.hbm_bytes / 1e9

    if verbose:
        print(f"[{arch} x {shape_name} x {rec['mesh']}] "
              f"lower={rec['lower_s']}s compile={rec.get('compile_s')}s")
        print("  memory a position:", rec["memory"])
        print("  counted: flops=%.3e bytes=%.3e collective=%.3e a position" %
              (terms["hlo_flops_per_chip"], terms["hlo_bytes_per_chip"],
               terms["collective_bytes_per_chip"]))
        print("  roofline (H100 data sheet): compute=%.3fms memory=%.3fms "
              "collective=%.3fms dominant=%s useful=%.2f" %
              (1e3 * terms["t_compute_s"], 1e3 * terms["t_memory_s"],
               1e3 * terms["t_collective_s"], terms["dominant"],
               terms["useful_ratio"]))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--no-compile", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.all or not args.arch else [args.arch]
    shapes = list(INPUT_SHAPES) if args.all or not args.shape else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape}_{'2pod' if mp else '1pod'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[skip] {tag} (exists)")
                    continue
                try:
                    rec = lower_combo(arch, shape, multi_pod=mp,
                                      compile_=not args.no_compile)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                except Exception as e:
                    traceback.print_exc()
                    failures.append((tag, repr(e)))
    if failures:
        print("FAILURES:")
        for tag, err in failures:
            print(" ", tag, err)
        raise SystemExit(1)
    print("dry-run complete.")


if __name__ == "__main__":
    main()
