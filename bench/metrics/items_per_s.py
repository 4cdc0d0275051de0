"""items_per_s: Table 1's work-items of every launch the window completed,
over the window (host clock; the window ends when its last launch has
returned)."""


def read(run):
    items = run.work.items(run.cell.config)
    return items * len(run.window.ok) / run.window.seconds
