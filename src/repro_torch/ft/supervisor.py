"""Fault-tolerance supervisor: checkpoint/restart, failure injection,
straggler mitigation, elastic scale-down.

The supervisor wraps a HeteroTrainer (or any object with the same
train_step/state_tree protocol) in a restart loop:

  * periodic async checkpoints,
  * on a (injected or real) step failure: restore the latest checkpoint
    and replay — the deterministic data pipeline guarantees the replayed
    steps see identical batches, so recovery is exact,
  * on a group failure: elastic scale-down (drop the group, redistribute
    its share) without restart,
  * stragglers flagged by the monitor trigger an immediate policy update
    (HGuided absorbs them; Static by design does not — the paper's point).

At 1000+ node scale this loop runs per-controller with the checkpoint in
replicated object storage; the logic is identical. The loop is the
reference's, step for step, over the port's trainer and checkpointer.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from ..checkpoint import Checkpointer
# FailurePlan and InjectedFailure live in the serving cluster tier
# (core.cluster), re-exported here as the reference re-exports them. This
# loop consumes the plan's step-keyed ``events``; the cluster adds the
# time-keyed ``timeline`` and JSON save/load on top.
from ..core.cluster import FailurePlan, InjectedFailure

__all__ = ["FailurePlan", "InjectedFailure", "Supervisor",
           "SupervisorReport"]


@dataclasses.dataclass
class SupervisorReport:
    steps_run: int
    restarts: int
    groups_lost: list[str]
    stragglers_seen: list[str]
    losses: list[float]


class Supervisor:
    def __init__(self, trainer, checkpointer: Checkpointer, *,
                 ckpt_every: int = 10,
                 failure_plan: Optional[FailurePlan] = None,
                 on_straggler: Optional[Callable[[str], None]] = None):
        self.trainer = trainer
        self.ckpt = checkpointer
        self.ckpt_every = max(1, ckpt_every)
        self.plan = failure_plan or FailurePlan(events={})
        self.on_straggler = on_straggler
        self.restarts = 0
        self.groups_lost: list[str] = []
        self.stragglers_seen: list[str] = []
        self._crashed_once: set[int] = set()

    def _maybe_checkpoint(self) -> None:
        if self.trainer.step % self.ckpt_every == 0:
            self.ckpt.save_async(self.trainer.step,
                                 self.trainer.state_tree())

    def _restore(self) -> None:
        self.ckpt.wait()
        step, tree = self.ckpt.restore(self.trainer.state_tree())
        self.trainer.load_state_tree(tree)
        self.restarts += 1

    def run(self, total_steps: int) -> SupervisorReport:
        losses: list[float] = []
        # initial checkpoint so a step-0 crash can restore
        self.ckpt.save(self.trainer.step, self.trainer.state_tree())
        while self.trainer.step < total_steps:
            step = self.trainer.step
            action = self.plan.check(step)
            try:
                if action == "crash" and step not in self._crashed_once:
                    self._crashed_once.add(step)
                    raise InjectedFailure(f"injected crash at step {step}")
                if action and action.startswith("kill:"):
                    g = action.split(":", 1)[1]
                    if g not in self.groups_lost:
                        self.trainer.kill_group(g)
                        self.groups_lost.append(g)
                report = self.trainer.train_step()
                losses.append(report.loss)
                for s in self.trainer.monitor.stragglers():
                    if s not in self.stragglers_seen:
                        self.stragglers_seen.append(s)
                        if self.on_straggler:
                            self.on_straggler(s)
                self._maybe_checkpoint()
            except InjectedFailure:
                self._restore()
        self.ckpt.wait()
        return SupervisorReport(
            steps_run=self.trainer.step,
            restarts=self.restarts,
            groups_lost=self.groups_lost,
            stragglers_seen=self.stragglers_seen,
            losses=losses,
        )
