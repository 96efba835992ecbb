"""Training launcher of the port (`repro.launch.train`).

Two modes:
  * LM:   train any assigned architecture (reduced with --smoke, or
          full) on the synthetic token stream: `decoder_lm.loss_fn`
          through the differentiable layer paths with per-block
          rematerialisation, the reference's AdamW applied in place
          (`optim.adamw_update_`), checkpoints in the JAX package's
          format. With `cfg.adaptive` enabled the loss trains the
          early-exit heads by Inception Distillation.
  * GNN:  the paper's training procedure (base model + Inception
          Distillation) on a synthetic graph dataset, then NAI inference
          over the test split; --ckpt writes the heads as the JAX
          package's params tree (`gnn.convert.params_to_numpy`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b --smoke --steps 6 --batch 2 --seq 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-34b --smoke --steps 40 --ckpt build/lm.ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --gnn pubmed-like --k 4
    PYTHONPATH=src python -m repro_torch.launch.train --gnn pubmed-like --k 2 --scale 0.03 --epochs 20 --device cpu

Runs on ``--device cuda`` unless told otherwise. Two differences from
the reference's LM loop, both faults of the reference (ROADMAP C): a
checkpoint saved after step i records i + 1 steps done (the reference
records i, so a resume repeats step i), and a resumed run skips the
stream's batches that the saved steps consumed (the reference starts the
stream again), so that a run killed after a checkpoint and resumed ends
bit-equal to one that was not.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.common import TrainConfig
from repro_torch.configs import ARCHS, get_config, smoke
from repro_torch.device import resolve_device
from repro_torch.nn.params import torch_dtype


def lm_batch(cfg, raw, device) -> dict:
    """A `synthetic_stream` batch on `device`: tokens as int64, the
    frontend stub (VLM, encoder-decoder) in the model's dtype."""
    out = {"tokens": torch.from_numpy(raw["tokens"]).long().to(device)}
    if "frontend" in raw:
        out["frontend"] = torch.from_numpy(raw["frontend"]).to(
            device, torch_dtype(cfg.dtype))
    return out


def lm_train_step(cfg, model, opt, tc: TrainConfig, sched, batch) -> dict:
    """One training step: `loss_fn`'s value and gradients (rematerialised
    per block when `tc.remat`), then the in-place AdamW update of the
    model's parameters and `opt`; the gradients are freed. A parameter
    the loss does not reach takes a zero gradient, as under
    `jax.value_and_grad`. `model` is a module, or a parameter tree placed
    by `shard_params(..., trainable=True)` (called inside `use_mesh`, the
    batch global, `opt` from `adamw_init` of the tree), whose copies'
    gradients `sync_grads` adds before the update. Returns the metrics
    (0-d tensors)."""
    from repro_torch.models import decoder_lm as M
    from repro_torch.optim import adamw_update_
    from repro_torch.sharding import placement as pl
    loss, metrics = M.loss_fn(cfg, model, batch, remat=tc.remat)
    loss.backward()
    metrics = {k: v.detach() for k, v in metrics.items()}
    if isinstance(model, dict):
        params, grads = model, pl.sync_grads(model)
    else:
        params = dict(model.named_parameters())
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
        for p in params.values():
            p.grad = None
    metrics.update(adamw_update_(grads, opt, params, tc,
                                 sched(opt["count"])))
    return metrics


def train_lm(args) -> dict:
    """Train `--arch` for `--steps` steps; returns the model and the
    optimizer state."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.data import synthetic_stream
    from repro_torch.models import decoder_lm as M
    from repro_torch.nn.params import count_params
    from repro_torch.optim import adamw_init, make_schedule
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke(cfg)
    tc = TrainConfig(learning_rate=args.lr, warmup_steps=args.steps // 10,
                     total_steps=args.steps, weight_decay=0.01)
    gen = torch.Generator(dev).manual_seed(args.seed)
    model = M.init_params(cfg, gen, device=dev).requires_grad_(True)
    params = dict(model.named_parameters())
    print(f"[train] {cfg.name} params={count_params(model):,} on {dev}")
    opt = adamw_init(params, tc)
    sched = make_schedule(tc)

    step_count = 0
    if args.resume and os.path.exists(args.ckpt):
        state, step_count = load_checkpoint(args.ckpt,
                                            {"params": params, "opt": opt})
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(state["params"][k])
        opt = state["opt"]
        print(f"[train] resumed from step {step_count}")

    stream = synthetic_stream(args.seed, args.batch, args.seq,
                              cfg.vocab_size, cfg)
    for _ in range(step_count):          # the batches the saved steps took
        next(stream)
    t0 = time.time()
    for i in range(step_count, args.steps):
        batch = lm_batch(cfg, next(stream), dev)
        metrics = lm_train_step(cfg, model, opt, tc, sched, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss={float(metrics['loss']):.4f} "
                  f"lm={float(metrics['lm_loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.2f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if args.ckpt and i + 1 < args.steps and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt, {"params": params, "opt": opt}, i + 1)
            print(f"[train] checkpoint -> {args.ckpt} (step {i + 1})",
                  flush=True)
    if args.ckpt:
        save_checkpoint(args.ckpt, {"params": params, "opt": opt},
                        args.steps)
        print(f"[train] checkpoint -> {args.ckpt} (step {args.steps})")
    return {"model": model, "opt": opt}


def train_gnn(args) -> None:
    from repro_torch.gnn import (DistillConfig, GNNConfig, NAIConfig,
                                 accuracy, infer_all, load_dataset,
                                 train_nai)
    dev = resolve_device(args.device)
    g = load_dataset(args.gnn, scale=args.scale, seed=args.seed)
    cfg = GNNConfig(args.base_model, g.features.shape[1], g.num_classes,
                    k=args.k, hidden=args.hidden, mlp_layers=2, dropout=0.1)
    dc = DistillConfig(epochs_base=args.epochs, epochs_offline=args.epochs // 2,
                       epochs_online=args.epochs // 2)
    print(f"[train-gnn] {args.gnn} n={g.n} m={g.num_edges} "
          f"base={args.base_model} k={cfg.k}")
    t0 = time.time()
    model, info = train_nai(cfg, g, dc, device=dev)
    print(f"[train-gnn] done in {time.time() - t0:.1f}s: "
          f"{ {k: round(v, 4) for k, v in info.items()} }")
    res = infer_all(cfg, NAIConfig(t_s=args.t_s, t_min=1, t_max=cfg.k // 2 + 1,
                                   batch_size=500), model, g)
    print(f"[train-gnn] NAI acc={accuracy(res, g):.4f} "
          f"fp_macs/node={res.fp_macs:.0f}")
    if args.ckpt:
        from repro_torch.checkpoint import save_checkpoint
        from repro_torch.gnn.convert import params_to_numpy
        save_checkpoint(args.ckpt, params_to_numpy(model), args.epochs)
        print(f"[train-gnn] checkpoint -> {args.ckpt}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--gnn", default=None)
    ap.add_argument("--base-model", default="sgc")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family variant")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--t-s", type=float, default=16.0)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.gnn:
        train_gnn(args)
    elif args.arch:
        return train_lm(args)
    else:
        ap.error("need --arch or --gnn")


if __name__ == "__main__":
    main()
