"""launch_mfu (whole launch): every launch's counted work at the card's
roofline (the larger of its operations over the peak rate and its bytes
over the memory bandwidth), summed over the window's launches, over the
window, in percent: the whole step's share of the card's peak."""


def read(run):
    launches = [r for r in run.window.ok if r.stats is not None]
    if not launches or run.peaks is None:
        return None
    bound = sum(run.bound_s(*run.counter(r.client).count(0, run.total))
                for r in launches)
    return 100.0 * bound / run.window.seconds
