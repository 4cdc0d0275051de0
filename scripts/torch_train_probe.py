#!/usr/bin/env python3
"""Where a full-width training step of the port spends its time, on one
CUDA card.

    PYTHONPATH=src python3 scripts/torch_train_probe.py

Builds qwen3-0.6b at full width (f32 master parameters, the plain
attention), draws one microbatch of 1 x 64 tokens, as ``chip_smoke.py``'s
phase 8 trains it, and times (synchronised wall clock, the median of 3):

- the forward pass alone (no gradient);
- ``value_and_grad`` of ``Model.loss`` with remat on and off, each with
  ``torch.use_deterministic_algorithms`` on and off;
- clipping and one AdamW update over the parameters;
- the checkpoint's parts: ``params_to_numpy`` of the parameters (the host
  copy in the reference's layout), ``np.savez`` of it and ``np.load``.

Then one bf16 GEMM of the MLP's shape (64 x 1024 by 1024 x 3072) is
timed on the host, per call, in a fresh process for each value of
``CUBLAS_WORKSPACE_CONFIG`` (unset, and the values deterministic cuBLAS
asks for), which cuBLAS reads once, when it makes its handle.

Then ``torch.profiler`` records one ``value_and_grad`` (remat and
deterministic algorithms on, as ``chip_smoke.py`` trains) and prints its
operators by device time and by host time, and the host time of its GEMMs
by their shapes; the whole table goes to ``chiprun_out/train_probe_ops.txt``.
Every line carries the card's name and power limit.
"""
import dataclasses
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCH, TOKENS, REPS = "qwen3-0.6b", 64, 3
WORKSPACE_CONFIGS = (None, ":4096:8", ":16:8")
# host microseconds a call of one bf16 GEMM, deterministic algorithms on
GEMM_HOST_US = """
import time, torch
torch.use_deterministic_algorithms(True)
x = torch.randn(64, 1024, device="cuda:0").bfloat16()
w = torch.randn(1024, 3072, device="cuda:0").bfloat16()
torch.mm(x, w)
torch.cuda.synchronize()
t = time.perf_counter()
for _ in range(300):
    torch.mm(x, w)
print((time.perf_counter() - t) / 300 * 1e6)
torch.cuda.synchronize()
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_train_probe: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, params_to_numpy
    from repro_torch.optim import AdamW, clip_by_global_norm, value_and_grad

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    cfg = dataclasses.replace(get_config(ARCH), attn_impl="xla")
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                   dev)
    g = torch.Generator(device=dev).manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (1, TOKENS + 1), generator=g,
                        device=dev)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    def timed(fn):
        out = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t)
        return statistics.median(out)

    def say(what, seconds):
        print(f"{ARCH}, {TOKENS} tokens: {what} {seconds:.4f} s ({card})",
              flush=True)

    models = {remat: build_model(dataclasses.replace(cfg, remat=remat))
              for remat in (True, False)}
    with torch.no_grad():
        models[True].loss(params, batch)
        say("forward, no gradient", timed(
            lambda: models[True].loss(params, batch)))
    for det in (True, False):
        torch.use_deterministic_algorithms(det)
        for remat, model in models.items():
            value_and_grad(model.loss, params, batch)
            say(f"value_and_grad, remat {remat}, deterministic {det}",
                timed(lambda: value_and_grad(model.loss, params, batch)))
    torch.use_deterministic_algorithms(True)
    _, grads = value_and_grad(models[True].loss, params, batch)
    say("clip_by_global_norm", timed(lambda: clip_by_global_norm(grads, 1.0)))
    opt = AdamW(lr=1e-3)
    state = opt.init(params)
    say("AdamW update (in place)",
        timed(lambda: opt.update(grads, state, params)))

    t = time.perf_counter()
    host = params_to_numpy(cfg, params)
    say("params_to_numpy (host copy, stacked)", time.perf_counter() - t)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "p.npz")
        t = time.perf_counter()
        np.savez(path, **{f"k{i}": a for i, a in enumerate(
            _leaves(host))})
        say(f"np.savez of the parameters "
            f"({os.path.getsize(path) / 1e9:.2f} GB)",
            time.perf_counter() - t)
        t = time.perf_counter()
        with np.load(path) as data:
            for key in data.files:
                data[key]
        say("np.load of the parameters", time.perf_counter() - t)

    for config in WORKSPACE_CONFIGS:
        env = {k: v for k, v in os.environ.items()
               if k != "CUBLAS_WORKSPACE_CONFIG"}
        if config is not None:
            env["CUBLAS_WORKSPACE_CONFIG"] = config
        us = float(subprocess.run([sys.executable, "-c", GEMM_HOST_US],
                                  env=env, capture_output=True, text=True,
                                  check=True).stdout)
        print(f"bf16 GEMM 64x1024x3072, CUBLAS_WORKSPACE_CONFIG {config}: "
              f"{us:.1f} us of host time a call ({card})", flush=True)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        value_and_grad(models[True].loss, params, batch)
        torch.cuda.synchronize()
    avg = prof.key_averages()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "train_probe_ops.txt").write_text(
        avg.table(sort_by="self_cpu_time_total", row_limit=200))
    device_key = ("self_device_time_total"
                  if hasattr(avg[0], "self_device_time_total")
                  else "self_cuda_time_total")
    for key in (device_key, "self_cpu_time_total"):
        print(f"-- by {key} ({card})")
        print(avg.table(sort_by=key, row_limit=18, max_name_column_width=48))
    # the host time of the GEMMs, by their input shapes
    mms = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.key == "aten::mm"]
    mms.sort(key=lambda e: -e.self_cpu_time_total)
    print(f"-- aten::mm by input shapes, host time ({card})")
    for e in mms[:12]:
        print(f"{e.count:5d} calls, {e.self_cpu_time_total / 1e3:9.3f} ms "
              f"self CPU ({e.self_cpu_time_total / e.count:8.1f} us a call): "
              f"{e.input_shapes}")
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
