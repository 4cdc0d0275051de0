"""LM serving loop: batched greedy decoding through ``decode_step``.

    python -m repro_torch.launch.serve --arch zamba2-7b

The port of the reference serve CLI's LM branch: for each batch of
requests, random prompts, a cache for prompt + new tokens, the prompt
stepped one token at a time through ``Model.decode_step``, then greedy
steps over the unpadded vocabulary. The CLI serves the reduced config
(as the reference does) on ``--device`` (``cuda:0`` unless the caller asks
for ``cpu``). The co-execution modes and the spec flags of the reference
CLI are not ported yet (ROADMAP queue 1 item 5).
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..models import Model, build_model


def serve_lm(model: Model, params, *, requests: int, batch: int,
             prompt_len: int, max_tokens: int, seed: int = 1,
             device: torch.device | str = "cuda:0") -> dict:
    """Serve ``requests`` random prompts in batches of ``batch``.

    Args:
        model: the built model; ``params`` its parameters on ``device``.
        requests: how many requests to serve.
        batch: requests per batch (the last batch is padded to it).
        prompt_len: tokens per prompt (P).
        max_tokens: tokens generated per request (G).
        seed: seeds the prompts' generator.
        device: where the cache and the tokens live.

    Returns:
        ``{"requests", "tokens", "seconds"}``: requests served, tokens
        processed (requests * (P + G)), and the wall time in seconds, up
        to the last batch's final token on the host.
    """
    device = torch.device(device)
    cfg = model.cfg
    B, P, G = batch, prompt_len, max_tokens
    gen = torch.Generator().manual_seed(seed)
    served = 0
    t0 = time.perf_counter()
    for _ in range(-(-requests // B)):
        n = min(B, requests - served)
        prompts = torch.randint(0, cfg.vocab_size, (B, P),
                                generator=gen).to(device)
        cache = model.init_cache(B, P + G, device=device)
        for t in range(P):
            logits, cache = model.decode_step(params, prompts[:, t:t + 1],
                                              cache)
        cur = torch.argmax(logits[:, :cfg.vocab_size], -1)[:, None]
        for _ in range(G - 1):
            logits, cache = model.decode_step(params, cur, cache)
            cur = torch.argmax(logits[:, :cfg.vocab_size], -1)[:, None]
        cur.cpu()                      # the batch's last token is done
        served += n
    return {"requests": served, "tokens": served * (P + G),
            "seconds": time.perf_counter() - t0}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default="cuda:0",
                    help="cuda:0 (default) or cpu")
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error(f"{device} is not available; pass --device cpu")
    cfg = get_config(args.arch).reduced()
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen, device)
    out = serve_lm(model, params, requests=args.requests, batch=args.batch,
                   prompt_len=args.prompt_len, max_tokens=args.max_tokens,
                   device=device)
    print(f"[serve] {out['requests']} requests, {out['tokens']} tokens in "
          f"{out['seconds']:.2f}s ({out['tokens'] / out['seconds']:.0f} "
          f"tok/s) on {device}")


if __name__ == "__main__":
    main()
