"""LM-decode serving: a batched decode loop with a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.lm_serve \
        --arch h2o-danube3-4b --batch 4 --prompt-len 32 --gen 16

The port of ``repro/launch/lm_serve.py``: requests are padded into a fixed
batch, the prompt fills the cache through teacher-forced decode steps
(token by token), then greedy decode.  Runs on the card (``--device``,
default ``cuda``; it raises without one); ``--device cpu`` runs the plain
PyTorch versions.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import model as M


def generate(cfg, params, prompts: np.ndarray, gen: int, max_len: int
             ) -> np.ndarray:
    """prompts: (B, P) int32. Greedy decode ``gen`` tokens, on the device
    of ``params``.  Returns (B, gen) int32."""
    b, plen = prompts.shape
    dev = params["embed"].device
    prompts_t = torch.as_tensor(np.asarray(prompts), device=dev).long()
    cache = M.init_cache(cfg, b, max_len, device=dev)
    out = torch.zeros((b, gen), dtype=torch.int32, device=dev)
    tok = prompts_t[:, 0]
    with torch.inference_mode():
        for pos in range(plen + gen - 1):
            logits, cache = M.decode_step(cfg, params, tok, cache, pos)
            if pos + 1 < plen:
                tok = prompts_t[:, pos + 1]              # teacher-forced
            else:
                tok = torch.argmax(logits, dim=-1)
                out[:, pos + 1 - plen] = tok
    return out.cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else \
        get_config(args.arch)
    if cfg.is_encoder_only:
        raise SystemExit("encoder-only arch has no decode step")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("lm_serve: no CUDA device; pass --device cpu to "
                         "run the plain PyTorch versions")
    params = M.init_params(
        cfg, torch.Generator(device).manual_seed(args.seed), device=device)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab,
                           (args.batch, args.prompt_len)).astype(np.int32)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = generate(cfg, params, prompts, args.gen,
                   args.prompt_len + args.gen)
    dt = time.perf_counter() - t0
    tput = args.batch * args.gen / dt
    print(f"arch={cfg.name} device={device} batch={args.batch} "
          f"gen={args.gen} -> {tput:.1f} tok/s ({dt:.1f}s)")
    print("sample:", out[0].tolist())
    assert np.isfinite(tput) and (out >= 0).all() and (out < cfg.vocab).all()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
