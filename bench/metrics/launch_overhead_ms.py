"""launch_overhead_ms (runtime and engine): the mean over the window's
launches of the latency less ``LaunchStats.total_s``, the part outside
the packages: plan (USM page-locking), admission wait and hand-off."""


def read(run):
    gaps = [r.latency_s - r.stats.total_s for r in run.window.ok
            if r.stats is not None]
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
