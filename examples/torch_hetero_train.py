"""End-to-end driver on the PyTorch port: train an LM for a few hundred
steps with heterogeneity-aware data parallelism (the paper's co-execution
applied to data-parallel training) + checkpointing + failure injection.

Reduced dims by default (groups simulated on one device); ``--full-size``
takes the published config, and ``--dry-run`` traces its full-width
train step on the meta device and prints its roofline on the card's mesh
instead of training (`--arch` picks any of the 10 assigned architectures).

    PYTHONPATH=src python examples/torch_hetero_train.py \
        --arch qwen3-0.6b --steps 200 --policy hguided
    PYTHONPATH=src python examples/torch_hetero_train.py --dry-run
"""
import argparse
import tempfile

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import DataPipeline
from repro_torch.ft import FailurePlan, Supervisor
from repro_torch.hetero import HeteroTrainer, make_policy
from repro_torch.models import build_model, count_params
from repro_torch.optim import AdamW, make_schedule


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--policy", default="hguided",
                    choices=["static", "dynamic", "hguided"])
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full published config")
    ap.add_argument("--dry-run", action="store_true",
                    help="trace the full config's train_4k step on the "
                         "meta device and print its roofline on the "
                         "card's mesh; no training")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--inject-crash-at", type=int, default=None)
    ap.add_argument("--device", default="cuda:0",
                    help="where the model trains (cpu for a machine "
                         "without a CUDA card)")
    args = ap.parse_args(argv)

    if args.dry_run:
        from repro_torch.launch.dryrun import run_cell
        run_cell(args.arch, "train_4k", "card")
        return

    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device)
    print(f"{args.arch}: {count_params(params):,} params "
          f"({'full' if args.full_size else 'reduced'}) on {device}")

    pipe = DataPipeline(seed=1, global_batch=args.microbatches,
                        seq_len=64 if not args.full_size else 4096,
                        vocab=cfg.vocab_size,
                        num_shards=args.microbatches)
    groups = {"podA": 1.0, "podB": 0.6, "podC": 0.3}
    lr = make_schedule(cfg.schedule, 3e-3, warmup=10, total=args.steps)
    trainer = HeteroTrainer(
        model, params, optimizer=AdamW(lr=lr),
        policy=make_policy(args.policy, {g: 1.0 for g in groups},
                           total_steps=args.steps),
        pipeline=pipe, group_speeds=groups,
        total_microbatches=args.microbatches)

    events = {}
    if args.inject_crash_at is not None:
        events[args.inject_crash_at] = "crash"
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="hetero_ckpt_")
    sup = Supervisor(trainer, Checkpointer(ckpt_dir), ckpt_every=25,
                     failure_plan=FailurePlan(events=events),
                     on_straggler=lambda g: print(f"  [straggler] {g}"))
    report = sup.run(args.steps)

    print(f"ran {report.steps_run} steps "
          f"({report.restarts} restarts, lost={report.groups_lost})")
    k = max(1, len(report.losses) // 10)
    for i in range(0, len(report.losses), k):
        r = trainer.history[min(i, len(trainer.history) - 1)]
        print(f"  step {i:4d}: loss={report.losses[i]:.4f} "
              f"assign={r.assignment} step_t={r.step_seconds * 1e3:.0f}ms")
    print(f"final loss: {report.losses[-1]:.4f}  "
          f"(checkpoints in {ckpt_dir})")


if __name__ == "__main__":
    main()
