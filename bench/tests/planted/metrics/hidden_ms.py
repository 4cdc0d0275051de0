"""hidden_ms (model): the mean ``hidden`` span over the window's launches,
the planted model's first layer."""
from bench.harness import idle


def read(run):
    return idle.mean_ms([s.seconds for s in idle.spans(run, "hidden")])
