"""setup_s: seconds from the process's start to the window: imports,
kernel builds on first use, and one pass of the window's shapes."""


def read(run):
    return run.setup_s
