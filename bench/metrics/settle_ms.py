"""settle_ms (runtime and engine): the mean ``settle`` span over the
window's launches: the release of a launch's plan (USM: unmapping its
arrays) after its last package, before its future is set."""
from bench.harness import idle


def read(run):
    return idle.mean_ms([s.seconds for s in idle.spans(run, "settle")])
