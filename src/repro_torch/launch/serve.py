"""Serving launcher of the port, LM mode: prefill a batch of synthetic
prompts, then decode greedily, through `repro_torch.models.decoder_lm`
(the full-sequence layers run kernels B4/B5 on the card).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b --tokens 64

GNN mode (`--gnn`) needs the NAI trainer and waits for ROADMAP A9.
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


def serve_lm(args) -> dict:
    """Prefill `--batch` prompts of `--tokens` tokens, decode `--tokens`
    more; returns the rates and the continuation."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke(cfg)
    gen = torch.Generator(dev).manual_seed(args.seed)
    params = M.init_params(cfg, gen, device=dev)
    B, S = args.batch, args.tokens
    prompt = synthetic_lm_batch(np.random.default_rng(args.seed), B, S,
                                cfg.vocab_size)["tokens"]
    tokens = torch.from_numpy(prompt).long().to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    logits, cache = M.prefill_step(cfg, params, tokens, length=2 * S)
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
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    serve_lm(ap.parse_args(argv))


if __name__ == "__main__":
    main()
