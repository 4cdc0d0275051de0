"""Training launcher: the hetero-DP training loop on one device.

Trains the reduced config of ``--arch`` (groups simulated on ``--device``,
``cuda:0`` by default) under the fault-tolerance supervisor, with
checkpoints in ``--ckpt-dir``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 100 --policy hguided --ckpt-dir /tmp/ckpt --device cpu

``--dry-run`` traces the full config of ``--arch`` at ``--shape`` on the
meta device and accounts for it on ``--mesh``: ``single`` (the default),
``multi`` (also ``--multi-pod``, the reference's flag) or ``card``, by
``launch/dryrun.py``'s ``run_cell``, which partitions the step on a fake
process group of the production mesh and ends that group before it
returns.
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Optional

import torch

SEED = 0


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--policy", default="hguided",
                    choices=["static", "dynamic", "hguided"])
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--groups", default="podA:1.0,podB:0.6,podC:0.3",
                    help="name:speed pairs for the device groups")
    ap.add_argument("--dry-run", action="store_true",
                    help="full config on the production mesh, traced "
                         "on the meta device only")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "card"],
                    default=None,
                    help="the dry run's mesh (single unless --multi-pod)")
    ap.add_argument("--device", default="cuda:0",
                    help="where the model trains (cuda:0 by default; cpu "
                         "for a machine without a CUDA card)")
    return ap


def main(argv: Optional[list[str]] = None) -> dict:
    """Parse ``argv``, train, print the reference's lines; returns the
    supervisor's report and the step the run started from (with
    ``--dry-run``, the cell's dry-run record)."""
    ap = _parser()
    args = ap.parse_args(argv)

    if args.dry_run:
        from .dryrun import run_cell
        mesh = args.mesh or ("multi" if args.multi_pod else "single")
        if args.multi_pod and mesh != "multi":
            ap.error(f"--multi-pod with --mesh {mesh}")
        return run_cell(args.arch, args.shape, mesh)
    device = torch.device(args.device)
    if device.type == "cuda" and (not torch.cuda.is_available() or (
            device.index or 0) >= torch.cuda.device_count()):
        ap.error(f"--device {args.device}: no such CUDA device here "
                 f"(use --device cpu)")

    from ..checkpoint import Checkpointer
    from ..configs import get_config
    from ..data import DataPipeline
    from ..ft import Supervisor
    from ..hetero import HeteroTrainer, make_policy
    from ..models import build_model, count_params
    from ..optim import AdamW, make_schedule

    groups = {}
    for part in args.groups.split(","):
        name, speed = part.split(":")
        groups[name] = float(speed)

    cfg = get_config(args.arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(SEED), device)
    print(f"[train] {args.arch} ({count_params(params):,} params, "
          f"reduced) × {len(groups)} groups, policy={args.policy}, "
          f"device={device}")

    pipe = DataPipeline(seed=1, global_batch=args.microbatches,
                        seq_len=args.seq_len, vocab=cfg.vocab_size,
                        num_shards=args.microbatches)
    trainer = HeteroTrainer(
        model, params,
        optimizer=AdamW(lr=make_schedule(cfg.schedule, 3e-3, 10,
                                         args.steps)),
        policy=make_policy(args.policy, {g: 1.0 for g in groups},
                           total_steps=args.steps),
        pipeline=pipe, group_speeds=groups,
        total_microbatches=args.microbatches)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="train_ckpt_")
    ck = Checkpointer(ckpt_dir)
    start = 0
    if args.resume and ck.latest_step() is not None:
        start, tree = ck.restore(trainer.state_tree())
        trainer.load_state_tree(tree)
        print(f"[train] resumed from step {start}")
    sup = Supervisor(trainer, ck, ckpt_every=args.ckpt_every)
    report = sup.run(args.steps)
    if report.losses:
        print(f"[train] done: {report.steps_run} steps, "
              f"loss {report.losses[0]:.4f} → {report.losses[-1]:.4f}, "
              f"ckpts in {ckpt_dir}")
    else:
        print(f"[train] done: {report.steps_run} steps, nothing to run "
              f"past step {start}, ckpts in {ckpt_dir}")
    return {"report": report, "start_step": start, "ckpt_dir": ckpt_dir}


if __name__ == "__main__":
    main()
