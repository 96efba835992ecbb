"""Training launcher of the port (`repro.launch.train`), GNN mode: the
paper's training procedure (base model + Inception Distillation) on a
synthetic graph dataset, then NAI inference over the test split.

    PYTHONPATH=src python -m repro_torch.launch.train --gnn pubmed-like --k 4
    PYTHONPATH=src python -m repro_torch.launch.train --gnn pubmed-like --k 2 --scale 0.03 --epochs 20 --device cpu

Runs on ``--device cuda`` unless told otherwise. LM training (`--arch`)
and checkpoints wait for ROADMAP A10.5 and A10.4.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import ARCHS
from repro_torch.device import resolve_device


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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--gnn", default=None)
    ap.add_argument("--base-model", default="sgc")
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--t-s", type=float, default=16.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.gnn:
        train_gnn(args)
    elif args.arch:
        raise NotImplementedError(
            "LM training (--arch) is not ported yet: ROADMAP A10.5")
    else:
        ap.error("need --arch or --gnn")


if __name__ == "__main__":
    main()
