#!/usr/bin/env python3
"""Time the port's wide linear-attention path (Dk in (128, 1024]) at
xlstm-1.3b's mLSTM shape, and the model's prefill, on one CUDA card.

    PYTHONPATH=<tree>/src python3 scripts/torch_linear_wide_probe.py \
        --label tree [--prefill] [--json build/wide_tree.json]

``<tree>`` is the checkout whose ``repro_torch`` is timed: run it once with
this checkout's ``src`` and once with an unpacked copy of another commit's
(``git archive``) to compare two versions on one card, in turns (A B B A).
Per dtype (f32, bf16), on the inputs ``chip_smoke.py``'s ``linear_inputs``
draws for the "xlstm" case (BH 16, T 512, Dk 1024, Dv 1025): the wrapper's
time (CUDA events over 20 launches, L2 flushed before each), each launched
kernel's own device time (``torch.profiler`` over 10 launches, by kernel
name), the error against the plain version, and whether two launches give
the same bits. ``--prefill``: xlstm-1.3b at full width (random bf16 dense
weights from a seeded generator), ``prefill_logits`` on 4 x 512 tokens
through the kernels, after a warm-up, three times. Prints the card's name
and power limit first; exits 2 without CUDA.
"""
import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (stdlib and numpy at import)

SHAPE = (16, 512, 1024, 1025)       # BH, T, Dk, Dv


def kernel_split(fn, reps: int) -> dict:
    """Mean device ms per launch of each CUDA kernel ``fn`` runs, by name,
    from ``torch.profiler`` over ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0 and ev.count > 0 and "Memcpy" not in ev.key:
            split[ev.key[:120]] = {"ms": dev_us / 1e3 / ev.count,
                                   "count": ev.count}
    return split


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="tree")
    parser.add_argument("--prefill", action="store_true")
    parser.add_argument("--json", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false; this probe runs on a "
              "CUDA card")
        return 2
    from repro_torch.kernels import linear_attention, linear_attention_plain

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    src = pathlib.Path(linear_attention.__code__.co_filename).parents[2]
    print(f"{args.label}: {card}; repro_torch from {src}", flush=True)
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    rec = {"label": args.label, "card": card, "shape": SHAPE, "cases": {}}
    BH, T, Dk, Dv = SHAPE
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        q, k, v, ld = chip_smoke.linear_inputs("xlstm", BH, T, Dk, Dv, dtype,
                                               dev, gen)
        got = linear_attention(q, k, v, ld)
        again = linear_attention(q, k, v, ld)
        want = linear_attention_plain(q, k, v, ld)
        torch.cuda.synchronize()
        diff = (got.float() - want.float())
        row_rel = float((diff.norm(dim=-1) / want.float().norm(dim=-1)
                         .clamp_min(1e-30)).max())
        ms = [chip_smoke.time_ms(lambda: linear_attention(q, k, v, ld), 20,
                                 flush) for _ in range(2)]
        split = kernel_split(lambda: linear_attention(q, k, v, ld), 10)
        case = {"ms": ms, "kernels": split,
                "max_abs_err": float(diff.abs().max()),
                "row_rel_l2_max": row_rel,
                "same_bits": bool(torch.equal(got, again))}
        rec["cases"][dname] = case
        print(f"{args.label} {dname} BH={BH} T={T} Dk={Dk} Dv={Dv}: ms "
              f"{ms[0]:.4f} {ms[1]:.4f}; max_abs_err {case['max_abs_err']:.3g}"
              f" row_rel_l2_max {row_rel:.4g}; two launches same bits "
              f"{case['same_bits']} [{card}]", flush=True)
        for name, s in split.items():
            print(f"  {s['ms']:.4f} ms x {s['count']}: {name}", flush=True)
        del q, k, v, ld, got, again, want, diff
    if args.prefill:
        from repro_torch.configs import get_config

        cfg = get_config("xlstm-1.3b")
        model, _, params = chip_smoke.build_pair(cfg, dev, gen)
        batch = chip_smoke.prefill_batch(cfg, dev, gen)
        times = []
        with torch.no_grad():
            model.prefill_logits(params, batch)              # warm-up
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                model.prefill_logits(params, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
        rec["prefill_s"] = times
        print(f"{args.label} xlstm-1.3b prefill_logits 4 x 512 (kernels): "
              f"{' '.join(f'{s:.4f}' for s in times)} s [{card}]",
              flush=True)
    if args.json:
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
