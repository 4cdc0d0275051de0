"""The closed loop: C clients, each with its own inputs, in one window.

Each client submits its next launch as soon as its last one returns (the
paper's application iterating a kernel), until the window's time is up;
the window closes when the last launch submitted in time has returned, so
its rate counts all the work and all the time. Every launch gets a fresh
output. A sample of each client's outputs, drawn from the seed by
reservoir sampling, is kept for the check after the window.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np

from .host import client_seed

GRACE_S = 60.0       # a launch may return this long after the window's time


@dataclasses.dataclass
class LaunchRecord:
    """One launch as its client saw it (host clock, ``perf_counter``)."""

    client: int
    t_submit: float                 # the client called launch_async
    t_handed: float                 # launch_async returned: plan, admission
    t_done: float                   # the result in hand (nan: never came)
    stats: object = None            # the launch's LaunchStats
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


@dataclasses.dataclass
class Window:
    """What the window saw: its bounds, the launches, the kept outputs."""

    t_start: float
    t_end: float
    records: list
    kept: dict          # client -> [outputs]

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start

    @property
    def ok(self) -> list:
        return [r for r in self.records if r.ok]


def warm_up(system, clients: int) -> None:
    """One untimed launch a client, one at a time."""
    for c in range(clients):
        system.submit(c).result()


def _client(system, c: int, deadline: float, keep: int, seed: int,
            records: list, kept: list) -> None:
    rng = np.random.default_rng(client_seed(seed, c, stream=1))
    served = 0
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline:
            return
        t1 = t0
        try:
            handle = system.submit(c)
            t1 = time.perf_counter()
            out = handle.result(timeout=max(deadline + GRACE_S
                                             - time.perf_counter(), 1e-3))
        except Exception as e:       # noqa: BLE001 - recorded as failed
            records.append(LaunchRecord(c, t0, t1, float("nan"),
                                        error=f"{type(e).__name__}: {e}"))
            return
        records.append(LaunchRecord(c, t0, t1, time.perf_counter(),
                                    stats=handle.stats))
        if served < keep:
            kept.append(out)
        else:
            j = int(rng.integers(0, served + 1))
            if j < keep:
                kept[j] = out
        served += 1


def run_window(system, clients: int, seconds: float, keep: int,
               seed: int) -> Window:
    """Drive ``clients`` closed-loop clients for ``seconds``.

    Returns:
        The window; it ends when the last launch has returned.
    """
    records = [[] for _ in range(clients)]
    kept = [[] for _ in range(clients)]
    t_start = time.perf_counter()
    deadline = t_start + seconds
    threads = [threading.Thread(target=_client, name=f"client-{c}",
                                args=(system, c, deadline, keep, seed,
                                      records[c], kept[c]), daemon=True)
               for c in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=max(deadline + GRACE_S + 30 - time.perf_counter(),
                            1.0))
    stuck = [c for c, th in enumerate(threads) if th.is_alive()]
    for c in stuck:
        records[c].append(LaunchRecord(c, deadline, deadline, float("nan"),
                                       error="client still waiting"))
    flat = sorted((r for rs in records for r in rs),
                  key=lambda r: r.t_submit)
    done = [r.t_done for r in flat if r.ok]
    return Window(t_start=t_start, t_end=max(done, default=deadline),
                  records=flat, kept={c: kept[c] for c in range(clients)})
