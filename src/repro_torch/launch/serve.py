"""Serving launcher of the port (`repro.launch.serve`).

  * GNN mode (the paper's scenario): train the NAI heads
    (`repro_torch.gnn.train_nai`), then serve a stream of unseen-node
    requests through `repro_torch.serving.NAIServingEngine`.
  * LM mode: prefill a batch of synthetic prompts, then decode greedily,
    through `repro_torch.models.decoder_lm` (the full-sequence layers run
    kernels B4/B5 on the card). VLM and encoder-decoder models get a
    stub frontend drawn as the reference draws it (standard normal image
    embeddings or audio frames, (B, N, d_model) in the model's dtype).

    PYTHONPATH=src python -m repro_torch.launch.serve --gnn pubmed-like
    PYTHONPATH=src python -m repro_torch.launch.serve --gnn pubmed-like --requests 200 --epochs 20 --k 2 --scale 0.03 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch grok-1-314b --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b --tokens 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small --smoke --device cpu

Both modes run on ``--device cuda`` unless told otherwise.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, smoke
from repro_torch.data.tokens import synthetic_lm_batch
from repro_torch.device import resolve_device
from repro_torch.models import decoder_lm as M
from repro_torch.nn.params import torch_dtype


def serve_gnn(args) -> None:
    from repro_torch.gnn import (DistillConfig, GNNConfig, NAIConfig,
                                 load_dataset, train_nai)
    from repro_torch.serving import NAIServingEngine
    dev = resolve_device(args.device)
    g = load_dataset(args.gnn, scale=args.scale, seed=args.seed)
    cfg = GNNConfig("sgc", g.features.shape[1], g.num_classes, k=args.k,
                    hidden=64, mlp_layers=2, dropout=0.1)
    dc = DistillConfig(epochs_base=args.epochs, epochs_offline=args.epochs // 2,
                       epochs_online=args.epochs // 2)
    print(f"[serve-gnn] training NAI model on {args.gnn} (n={g.n})...")
    model, _ = train_nai(cfg, g, dc, device=dev)
    nai = NAIConfig(t_s=args.t_s, t_min=1, t_max=args.k // 2 + 1,
                    batch_size=args.batch)
    engine = NAIServingEngine(cfg, nai, model, g, device=dev)

    rng = np.random.default_rng(args.seed)
    n_req = min(args.requests, len(g.test_idx))
    reqs = rng.choice(g.test_idx, size=n_req, replace=False)
    t0 = time.perf_counter()
    engine.submit(reqs)
    stats = engine.run_until_drained()
    dt = time.perf_counter() - t0
    s = stats.summary()
    print(f"[serve-gnn] served={s['served']} batches={s['batches']} "
          f"in {dt:.2f}s ({1e3 * dt / max(s['served'], 1):.2f} ms/req)")
    print(f"[serve-gnn] p50={s['p50_ms']:.1f}ms p95={s['p95_ms']:.1f}ms "
          f"p99={s['p99_ms']:.1f}ms mean_exit_order={s['mean_exit_order']:.2f}")
    print(f"[serve-gnn] exit histogram: {dict(sorted(stats.exit_hist.items()))}")


def serve_lm(args) -> dict:
    """Prefill `--batch` prompts of `--tokens` tokens (with the stub
    frontend of a VLM or encoder-decoder), decode `--tokens` more; returns
    the rates and the continuation."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke(cfg)
    # a smoke model is drawn on the host, so that its weights, and the
    # continuation, are the same on every device; a full one on the card
    gen = torch.Generator("cpu" if args.smoke else dev).manual_seed(
        args.seed)
    params = M.init_params(cfg, gen, device="cpu" if args.smoke else dev
                           ).to(dev)
    B, S = args.batch, args.tokens
    rng = np.random.default_rng(args.seed)
    prompt = synthetic_lm_batch(rng, B, S, cfg.vocab_size)["tokens"]
    tokens = torch.from_numpy(prompt).long().to(dev)
    frontend = None
    if cfg.is_encdec or cfg.num_image_tokens:
        n = cfg.encoder_seq if cfg.is_encdec else cfg.num_image_tokens
        frontend = torch.from_numpy(rng.standard_normal(
            (B, n, cfg.d_model))).to(dev, torch_dtype(cfg.dtype))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    logits, cache = M.prefill_step(cfg, params, tokens, frontend=frontend,
                                   length=2 * S)
    tok = logits.argmax(-1, keepdim=True)
    sync()
    t_prefill = time.perf_counter() - t0
    out = [tok[:, 0].cpu().numpy()]
    t0 = time.perf_counter()
    for t in range(S, 2 * S - 1):
        step_logits, cache = M.decode_step(cfg, params, cache, tok, t)
        tok = step_logits[:, 0].argmax(-1, keepdim=True)
        out.append(tok[:, 0].cpu().numpy())
    sync()
    t_decode = time.perf_counter() - t0
    steps = max(S - 1, 1)
    res = {"prefill_tok_s": B * S / t_prefill,
           "decode_ms_per_step": 1e3 * t_decode / steps,
           "decode_tok_s": B * steps / t_decode,
           "continuation": np.stack(out, axis=1)}
    print(f"[serve-lm] {cfg.name} on {dev}: prefill {B}x{S} tokens "
          f"{res['prefill_tok_s']:.1f} tok/s; decode {steps} steps "
          f"{res['decode_ms_per_step']:.1f} ms/step "
          f"({res['decode_tok_s']:.1f} tok/s)")
    print(f"[serve-lm] sample continuation: {res['continuation'][0, :8]}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gnn", default=None)
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=1000)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--t-s", type=float, default=16.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.gnn:
        serve_gnn(args)
    elif args.arch:
        return serve_lm(args)
    else:
        ap.error("need --gnn or --arch")


if __name__ == "__main__":
    main()
