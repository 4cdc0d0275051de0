"""setup_s: from the process's start to the window's: imports, the CUDA
context, the kernel library's load (and build, in a checkout's first
run), the inputs, the speed shares and the warm-up launches."""


def read(run):
    return run.setup_s
