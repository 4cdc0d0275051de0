"""map_lock_wait_ms (data plane): the mean per launch of the seconds its
``plan`` and ``settle`` spans waited for the process's one lock over
mapped host ranges (their ``lock_wait_s`` counts), over the launches
that took it (none on CPU units alone)."""
from bench.harness import idle

# CPU units map no host range, so no launch takes the mapping lock and no
# plan or settle carries a lock_wait_s count
CPU_READS = False


def read(run):
    waits = []
    for tl in idle.timelines(run):
        got = [s.count("lock_wait_s", None) for s in tl if s.name in idle.USM]
        if any(w is not None for w in got):
            waits.append(sum(w for w in got if w is not None))
    return idle.mean_ms(waits)
