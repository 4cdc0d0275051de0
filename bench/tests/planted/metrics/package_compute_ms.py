"""package_compute_ms (unit): the mean ``compute`` span over every package
of the window's launches, on any unit."""
from bench.harness import idle


def read(run):
    return idle.mean_ms([s.seconds for s in idle.spans(run, "compute")])
