"""Batched serving example on the PyTorch port: prefill + greedy decode
with the KV cache, reporting per-phase throughput. Works for every
assigned arch (SSM/hybrid archs use their O(1) recurrent state instead of
a KV ring).

    PYTHONPATH=src python examples/torch_serve_lm.py --arch h2o-danube3-4b \
        --batch 8 --prompt-len 64 --gen 32
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""
import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build_model


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube3-4b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda:0",
                    help="where the model runs (cpu for a machine without "
                         "a CUDA card)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    cfg = get_config(args.arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    B, P, G = args.batch, args.prompt_len, args.gen
    prompts = torch.randint(0, cfg.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(1)
                            ).to(device)
    with torch.no_grad():
        cache = model.init_cache(B, P + G, device=device)
        if model.prefill is not None:   # enc-dec: run the encoder once
            batch = {"tokens": prompts,
                     "frames": torch.zeros(B, cfg.encoder_seq, cfg.d_model,
                                           dtype=torch.bfloat16,
                                           device=device)}
            cache = model.prefill(params, batch, cache)

        t0 = time.perf_counter()
        for t in range(P):              # prefill via the cached decode path
            logits, cache = model.decode_step(params, prompts[:, t:t + 1],
                                              cache)
        sync()
        t_prefill = time.perf_counter() - t0

        cur = torch.argmax(logits[:, :cfg.vocab_size], -1)[:, None]
        out = [cur]
        t0 = time.perf_counter()
        for _ in range(G - 1):
            logits, cache = model.decode_step(params, cur, cache)
            cur = torch.argmax(logits[:, :cfg.vocab_size], -1)[:, None]
            out.append(cur)
        sync()
        t_decode = time.perf_counter() - t0

    gen = torch.cat(out, dim=1)
    print(f"arch={args.arch} batch={B} device={device}")
    print(f"prefill: {B * P / t_prefill:8.0f} tok/s "
          f"({t_prefill * 1e3:.0f} ms for {B * P} tokens)")
    print(f"decode : {B * (G - 1) / t_decode:8.0f} tok/s "
          f"({t_decode * 1e3 / (G - 1):.1f} ms/step)")
    print(f"sample generation (row 0): {gen[0, :12].tolist()}")


if __name__ == "__main__":
    main()
