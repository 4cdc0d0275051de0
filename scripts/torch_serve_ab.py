#!/usr/bin/env python3
"""Time ``serve_lm`` of one model at full width from two source trees, in
turns, on one card.

    python3 scripts/torch_serve_ab.py --tree <dir> --tree <dir> \
        [--arch zamba2-7b] [--order ABBA] [--serves 3]

Each turn is a fresh process that imports ``repro_torch`` from its tree's
``src``, builds ``--arch`` at full width through the hand kernels (flash
attention, the Pallas-path mixers) with random bf16 dense weights from
the seed, prefills 4 x 512 tokens once to warm up, then runs ``serve_lm``
(4 requests, batch 4, prompt 64, 16 new tokens) ``--serves`` times and
prints its tokens/s. The trees take turns in ``--order`` (``A`` the first
``--tree``, ``B`` the second), so both see the card in the same states.
An older tree may be unpacked with ``git archive <commit> src`` into a
directory that ``.gitignore`` lists. Prints one JSON object a turn, then
the card's ``nvidia-smi`` name and power limit; exits 2 without CUDA.
"""
import argparse
import json
import os
import pathlib
import subprocess
import sys

TURN = r"""
import dataclasses, json, sys, time
import torch
from repro_torch.configs import get_config
from repro_torch.launch.serve import serve_lm
from repro_torch.models import build_model

arch, seed, serves = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dev = torch.device("cuda:0")
cfg = dataclasses.replace(get_config(arch), attn_impl="flash",
                          mixer_impl="pallas")
model = build_model(cfg)
gen = torch.Generator(device=dev).manual_seed(seed)
params = model.init(gen, dev, dense_dtype=torch.bfloat16)
rates = []
with torch.no_grad():
    tokens = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen,
                           device=dev)
    model.prefill_logits(params, {"tokens": tokens})
    torch.cuda.synchronize()
    for _ in range(serves):
        out = serve_lm(model, params, seed=seed, device=dev, requests=4,
                       batch=4, prompt_len=64, max_tokens=16)
        rates.append(out["tokens"] / out["seconds"])
print("TURN " + json.dumps({"tokens_per_s": rates}), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", required=True,
                    help="a source tree (twice: A, then B)")
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--serves", type=int, default=3)
    ap.add_argument("--seed", type=int, default=2106)
    args = ap.parse_args()
    if len(args.tree) != 2:
        ap.error("--tree twice")
    import torch
    if not torch.cuda.is_available():
        print("torch_serve_ab: no CUDA card", flush=True)
        return 2
    trees = {"A": pathlib.Path(args.tree[0]).resolve(),
             "B": pathlib.Path(args.tree[1]).resolve()}
    for turn in args.order:
        tree = trees[turn]
        env = dict(os.environ, PYTHONPATH=str(tree / "src"))
        out = subprocess.run(
            [sys.executable, "-c", TURN, args.arch, str(args.seed),
             str(args.serves)], env=env, cwd=tree, capture_output=True,
            text=True, timeout=1800)
        if out.returncode:
            print(out.stderr[-3000:], flush=True)
            return out.returncode
        line = [x for x in out.stdout.splitlines() if x.startswith("TURN ")]
        print(json.dumps({"turn": turn, "tree": args.tree["AB".index(turn)],
                          "arch": args.arch,
                          **json.loads(line[-1][len("TURN "):])}),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
