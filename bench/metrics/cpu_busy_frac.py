"""cpu_busy_frac (unit): the ``cpu`` unit's busy seconds
(``LaunchStats.unit_busy_s``) over the window."""


def read(run):
    names = [name for name, kind in run.units if kind == "cpu"]
    if not names:
        return None
    busy = sum(r.stats.unit_busy_s.get(name, 0.0) for r in run.window.ok
               if r.stats is not None for name in names)
    return busy / run.window.seconds
