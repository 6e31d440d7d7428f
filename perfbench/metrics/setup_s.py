"""setup_s: seconds from the process's start to the first timed request or
step (imports, the kernel library, weights, warm-up, and in a train cell
the checked first steps)."""


def read(run):
    return run.setup_s
