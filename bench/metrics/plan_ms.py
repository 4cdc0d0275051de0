"""plan_ms (runtime and engine): the mean ``plan`` span over the window's
launches: from ``launch_async``'s entry (scheduler, output) through the
data plane's plan (USM: page-locking and mapping the output C) and the
kernel's pre-warm, to the engine's admission."""
from bench.harness import idle


def read(run):
    return idle.mean_ms([s.seconds for s in idle.spans(run, "plan")])
