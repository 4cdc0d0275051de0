"""The paper's load balancers lifted to step-level data-parallel
rebalancing (pure Python, the reference's policies decision for decision).

oneAPI's limitation — a kernel's device split is fixed at compile time — is
a compiled SPMD step's: one compiled step bakes in one batch sharding. The
Coexecutor answer maps onto training as *ratio scheduling*: each device
group's share of the global batch is re-decided between steps.

* ``StaticPolicy``   — shares fixed from hints forever (the paper's Static:
                       one decision, no adaptation).
* ``DynamicPolicy``  — every `period` steps, jump straight to the measured
                       throughput shares (the paper's Dynamic(N): the
                       training run is N = total/period packages re-split
                       on demand; small period = Dyn200, large = Dyn5).
* ``HGuidedPolicy``  — shares move toward measured throughput by a step
                       size that *shrinks* as training progresses, with a
                       minimum-share floor — the HGuided package-size law
                       ``max(min_pkg, rem·speed/(K·Σspeed))`` expressed in
                       ratio space: aggressive big corrections early, fine
                       trim later, never starving a live group.

Every policy emits shares quantized later by sharder.py; a changed
assignment costs one step-cache entry (a compile, in the reference) — the
analogue of the package-launch overhead the paper charges per package.
"""
from __future__ import annotations

import abc

# the scale-down/scale-up ratio moves are shared with the serving
# cluster tier's Supervisor (pure functions of core.cluster)
from ..core.cluster import absorb_share, grant_share


class RebalancePolicy(abc.ABC):
    name = "base"

    def __init__(self, hints: dict[str, float]):
        tot = sum(hints.values())
        self.shares_: dict[str, float] = {k: v / tot for k, v in
                                          hints.items()}

    @property
    def shares(self) -> dict[str, float]:
        return dict(self.shares_)

    def drop_group(self, name: str) -> None:
        """Elastic scale-down: dead group's share redistributes ∝ rest."""
        self.shares_ = absorb_share(self.shares_, name)

    def add_group(self, name: str, hint_share: float) -> None:
        """Elastic scale-up: newcomer enters at its hint share."""
        self.shares_ = grant_share(self.shares_, name, hint_share)

    @abc.abstractmethod
    def update(self, step: int, measured: dict[str, float]) -> bool:
        """Ingest measured shares; return True if shares changed."""


class StaticPolicy(RebalancePolicy):
    name = "static"

    def update(self, step: int, measured: dict[str, float]) -> bool:
        return False


class DynamicPolicy(RebalancePolicy):
    name = "dynamic"

    def __init__(self, hints: dict[str, float], *, period: int = 10):
        super().__init__(hints)
        self.period = max(1, period)

    def update(self, step: int, measured: dict[str, float]) -> bool:
        if step % self.period or not measured:
            return False
        keep = {k: v for k, v in measured.items() if k in self.shares_}
        tot = sum(keep.values())
        if tot <= 0:
            return False
        new = {k: v / tot for k, v in keep.items()}
        changed = any(abs(new[k] - self.shares_[k]) > 1e-3 for k in new)
        self.shares_ = new
        return changed


class HGuidedPolicy(RebalancePolicy):
    name = "hguided"

    def __init__(self, hints: dict[str, float], *, total_steps: int,
                 divisor: float = 2.0, min_share: float = 0.02):
        super().__init__(hints)
        self.total_steps = max(1, total_steps)
        self.divisor = divisor
        self.min_share = min_share

    def update(self, step: int, measured: dict[str, float]) -> bool:
        keep = {k: v for k, v in measured.items() if k in self.shares_}
        tot = sum(keep.values())
        if tot <= 0:
            return False
        target = {k: v / tot for k, v in keep.items()}
        # HGuided step size: remaining/(K·total) of the gap, floored — big
        # corrections while most of the run remains, trim near the end.
        remaining = max(0.0, 1.0 - step / self.total_steps)
        eta = max(0.1, remaining / self.divisor)
        changed = False
        new = {}
        for k, s in self.shares_.items():
            n = s + eta * (target.get(k, s) - s)
            new[k] = n
            changed |= abs(n - s) > 1e-3
        tot = sum(new.values())
        new = {k: v / tot for k, v in new.items()}
        # enforce the floor *after* normalization: lift floored groups and
        # take the excess proportionally from the rest (one pass suffices
        # for min_share « 1/num_groups)
        deficit = sum(max(0.0, self.min_share - v) for v in new.values())
        if deficit > 0:
            above = sum(v for v in new.values() if v > self.min_share)
            new = {k: (self.min_share if v <= self.min_share else
                       v - deficit * (v / above))
                   for k, v in new.items()}
        self.shares_ = new
        return changed


def make_policy(name: str, hints: dict[str, float], *,
                total_steps: int = 1000, period: int = 10,
                min_share: float = 0.02) -> RebalancePolicy:
    name = name.lower()
    if name == "static":
        return StaticPolicy(hints)
    if name.startswith("dyn"):
        if name not in ("dyn", "dynamic"):
            period = max(1, total_steps // int(name[3:]))
        return DynamicPolicy(hints, period=period)
    if name == "hguided":
        return HGuidedPolicy(hints, total_steps=total_steps,
                             min_share=min_share)
    raise KeyError(name)
