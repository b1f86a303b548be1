"""Set-up seconds: process start to the window's start (imports, the
kernels' load or build, the pool, the warm-up), host clock."""


def read(run):
    return run.setup_s
