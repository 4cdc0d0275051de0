"""prefill_ms (model): the mean ``prefill`` span over the window's
launches, the batch's prompts through the kernels into both caches."""
from bench.harness import idle


def read(run):
    return idle.mean_ms([s.seconds for s in idle.spans(run, "prefill")])
