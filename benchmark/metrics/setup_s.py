"""setup_s: seconds from the process's start to the first timed request."""

from benchmark import readers


def read(run):
    return readers.setup_s(run)
