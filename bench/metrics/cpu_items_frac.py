"""cpu_items_frac (control plane): the items of the ``cpu`` unit's
packages over all items of the window's launches."""


def read(run):
    cpu = every = 0
    for r in run.window.ok:
        for p in getattr(r.stats, "packages", ()):
            every += p.size
            cpu += p.size if run.unit_kind(p.unit) == "cpu" else 0
    has_cpu = any(kind == "cpu" for _, kind in run.units)
    return cpu / every if every and has_cpu else None
