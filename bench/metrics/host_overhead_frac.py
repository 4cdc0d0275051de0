"""host_overhead_frac (data plane): staging plus collection seconds of
every package, from the ``Package`` stamps (``t_launch - t_issue`` and
``t_collected - t_complete``), over the window."""


def read(run):
    packages = [p for r in run.window.ok
                for p in getattr(r.stats, "packages", ())]
    if not packages:
        return None
    host = sum((p.t_launch - p.t_issue) + (p.t_collected - p.t_complete)
               for p in packages)
    return host / run.window.seconds
