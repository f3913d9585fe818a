"""Serving driver: batched prefill + KV-cache decode with seeded random
weights (the counterpart of `repro.launch.serve`).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_0p6b \
        --batch 4 --prompt-len 64 --max-new 32            # reduced widths
    PYTHONPATH=src python -m repro_torch.launch.serve --full   # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llama4_maverick_400b_a17b                # MoE, reduced

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch mamba2_1p3b|zamba2_2p7b|seamless_m4t_medium|llama_3p2_vision_90b

Runs on the card (``--device cuda``, the default) unless asked for the
CPU; ``--full`` keeps the architecture's published widths and depth.
Every family serves: dense, MoE (``kimi_k2_1t_a32b``,
``llama4_maverick_400b_a17b``), SSM, hybrid, enc-dec and VLM. The enc-dec
and VLM configs' prompts come with seeded standard-normal stub frontend
embeddings (``frames`` / ``patches``, ``n_frontend_tokens`` x
``frontend_dim`` a sample, bf16), as `repro.launch.serve` draws them.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.data.pipeline import frontend_name
from repro_torch.models import build
from repro_torch.serve.step import generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0p6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    bundle = build(cfg, device=args.device)
    gen = torch.Generator(device=bundle.device).manual_seed(0)
    params = bundle.init(gen)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen,
        device=bundle.device)}
    if cfg.frontend:
        batch[frontend_name(cfg)] = torch.randn(
            (args.batch, cfg.n_frontend_tokens,
             cfg.frontend_dim or cfg.d_model), generator=gen,
            device=bundle.device).to(torch.bfloat16)

    on_card = bundle.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = generate(bundle, params, batch, args.max_new,
                    temperature=args.temperature, generator=gen)
    if on_card:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(bundle.device) if on_card else "cpu"
    print(f"arch={cfg.name} generated {tuple(toks.shape)} in {dt:.2f}s "
          f"({args.batch * args.max_new / dt:.1f} tok/s) on {where}")
    print("first sequence:", toks[0].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
