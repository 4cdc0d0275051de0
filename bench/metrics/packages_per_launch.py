"""packages_per_launch (control plane): the mean of
``LaunchStats.num_packages`` over the window's launches."""


def read(run):
    counts = [r.stats.num_packages for r in run.window.ok
              if r.stats is not None]
    return sum(counts) / len(counts) if counts else None
