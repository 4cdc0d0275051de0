"""HeteroTrainer: co-executed data-parallel training across unequal groups.

The training-step analogue of the Coexecutor Runtime: the global batch is a
queue of microbatch *packages*; each device group receives a quantized
share (policy-driven: static / dynamic / hguided), computes its partial
gradient, and the step closes with a gradient combine — the collect/merge
phase of the Commander loop.

The groups are *simulated*, as the reference's are: every group runs on
the model's device, and reports a virtual wall time, its real time divided
by its speed (a 0.5x group is a half-speed card, or a straggling one). The
real time includes the device's work: each microbatch's loss is read back
after its backward pass, which waits for the stream. The gradient math is
that of homogeneous data-parallel training — assignments change *where*
microbatches run, never their content or the order their gradients are
summed in — so loss trajectories do not depend on the policy.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from ..data import DataPipeline
from ..models.convert import params_from_numpy, params_to_numpy
from ..optim import AdamW, AdamWState, clip_by_global_norm, value_and_grad
from ..tree import tree_map
from .monitor import GroupMonitor
from .rebalance import RebalancePolicy
from .sharder import ExecutableCache, quantize_shares

Params = Any


@dataclasses.dataclass
class StepReport:
    step: int
    loss: float
    assignment: dict[str, int]
    group_seconds: dict[str, float]   # virtual per-group wall time
    step_seconds: float               # max over groups (barrier)
    rebalanced: bool


class HeteroTrainer:
    """Trains ``model`` from ``params`` (the port's tree, on the device
    every group runs on; updated in place by the optimizer)."""

    def __init__(self, model, params: Params, *, optimizer: AdamW,
                 policy: RebalancePolicy, pipeline: DataPipeline,
                 group_speeds: dict[str, float],
                 total_microbatches: int,
                 grad_clip: float = 1.0,
                 monitor: Optional[GroupMonitor] = None):
        self.model = model
        self.params = params
        self.optimizer = optimizer
        self.opt_state = optimizer.init(params)
        self.policy = policy
        self.pipeline = pipeline
        self.group_speeds = dict(group_speeds)
        self.total_microbatches = total_microbatches
        self.grad_clip = grad_clip
        self.monitor = monitor or GroupMonitor(list(group_speeds))
        self.step = 0
        # eager PyTorch compiles nothing: the cache holds the step's two
        # functions and counts the distinct assignments
        self.exec_cache = ExecutableCache(
            lambda key: (self._grad_fn, self._apply))
        self.history: list[StepReport] = []

    @property
    def device(self) -> torch.device:
        return self.params["embed"]["table"].device

    def _grad_fn(self, batch: dict) -> tuple[torch.Tensor, Params]:
        return value_and_grad(self.model.loss, self.params, batch)

    def _apply(self, grads: Params) -> torch.Tensor:
        grads, gnorm = clip_by_global_norm(grads, self.grad_clip)
        self.params, self.opt_state = self.optimizer.update(
            grads, self.opt_state, self.params)
        return gnorm

    def _batch(self, step: int, shard: int) -> dict:
        """Microbatch ``shard`` of ``step`` on the model's device (token
        ids as int64)."""
        return {k: torch.from_numpy(v).to(self.device, torch.long)
                for k, v in self.pipeline.batch_at(step, shard).items()}

    # ------------------------------------------------------------------
    def _assignment(self) -> dict[str, int]:
        alive = self.monitor.alive()
        shares = {k: v for k, v in self.policy.shares.items() if k in alive}
        tot = sum(shares.values())
        shares = {k: v / tot for k, v in shares.items()}
        return quantize_shares(shares, self.total_microbatches)

    def kill_group(self, name: str) -> None:
        """Elastic scale-down (node failure / preemption)."""
        self.monitor.mark_dead(name)
        self.policy.drop_group(name)

    def train_step(self) -> StepReport:
        assignment = self._assignment()
        grad_fn, apply = self.exec_cache.get(assignment)

        # deterministic global partition: microbatch i of this step is
        # identical no matter which group runs it
        mb_ids = list(range(self.total_microbatches))
        cursor = 0
        total_loss = 0.0
        grads_sum = None
        group_seconds: dict[str, float] = {}

        for name, count in assignment.items():
            ids = mb_ids[cursor:cursor + count]
            cursor += count
            t0 = time.perf_counter()
            for i in ids:
                loss, grads = grad_fn(self._batch(self.step, i))
                total_loss += float(loss)     # waits for the backward
                if grads_sum is None:
                    grads_sum = grads
                else:
                    tree_map(torch.Tensor.add_, grads_sum, grads)
                # no tree but the sum outlives its microbatch: a last
                # microbatch's gradients held through the optimizer step
                # would cost one more copy of the parameters
                del grads
            real = time.perf_counter() - t0
            virtual = real / self.group_speeds[name]
            group_seconds[name] = virtual
            tokens = count * self.pipeline.seq_len * (
                self.pipeline.global_batch // self.pipeline.num_shards)
            self.monitor.record(name, tokens, virtual)

        scale = 1.0 / self.total_microbatches
        apply(tree_map(lambda g: g.mul_(scale), grads_sum))

        measured = self.monitor.shares()
        rebalanced = self.policy.update(self.step, measured)
        report = StepReport(
            step=self.step,
            loss=total_loss / self.total_microbatches,
            assignment=assignment,
            group_seconds=group_seconds,
            step_seconds=max(group_seconds.values()),
            rebalanced=rebalanced,
        )
        self.history.append(report)
        self.step += 1
        return report

    def run(self, steps: int) -> list[StepReport]:
        return [self.train_step() for _ in range(steps)]

    # -- checkpoint integration ----------------------------------------
    def state_tree(self) -> dict:
        """The reference's checkpoint layout, as fresh numpy arrays:
        parameters and AdamW's ``m`` and ``v`` stacked as the reference
        stacks them, ``opt_step`` int32 and ``step``."""
        cfg = self.model.cfg
        return {"params": params_to_numpy(cfg, self.params),
                "m": params_to_numpy(cfg, self.opt_state.m),
                "v": params_to_numpy(cfg, self.opt_state.v),
                "opt_step": self.opt_state.step.numpy().copy(),
                "step": np.asarray(self.step, np.int32)}

    def load_state_tree(self, tree: dict) -> None:
        """Take a state in the reference's layout (numpy leaves)."""
        cfg, device = self.model.cfg, self.device
        self.params = params_from_numpy(cfg, tree["params"], device=device)
        self.opt_state = AdamWState(
            step=torch.as_tensor(np.asarray(tree["opt_step"], np.int32)),
            m=params_from_numpy(cfg, tree["m"], device=device),
            v=params_from_numpy(cfg, tree["v"], device=device))
        self.step = int(tree["step"])
