"""launch_mfu (whole launch): every launch's counted work at the card's
roofline (the larger of its operations over the peak rate and its bytes
over the memory bandwidth), summed over the window's launches
(``roofline.launch_bound_s``), over the window, in percent: the whole
step's share of the card's peak."""
from bench.harness import roofline

# reads the card's peaks, which a CPU run has none of
CPU_READS = False


def read(run):
    bound = roofline.launch_bound_s(run)
    return 100.0 * bound / run.window.seconds if bound else None
