"""decode_step_ms (model): the ``decode`` spans' seconds over their
``steps`` counts, over the window's launches, in ms: one decode step of
the batch through the KV and SSD caches."""
from bench.harness import idle


def read(run):
    spans = idle.spans(run, "decode")
    steps = sum(s.count("steps") for s in spans)
    return 1e3 * sum(s.seconds for s in spans) / steps if steps else None
