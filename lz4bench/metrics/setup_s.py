"""``setup_s``: host-clock seconds from the start of the process's
benchmark code to the first timed call: imports, the CUDA context, the
kernel library's load (and its build, in a checkout's first run), the
inputs, the frames written in set-up, and the warm-up calls."""


def read(run, kind):
    return run.setup_s
