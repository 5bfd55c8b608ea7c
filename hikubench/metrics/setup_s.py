"""setup_s: seconds from the process's start to the window's first due
request: imports, the endpoints' set-up, the kernels' build in a checkout's
first run, and the warm-up that leaves the pools as the traffic does."""


def read(run):
    return run.setup_s
