"""mpix_per_s: frames completed in the window x h x w / 1e6 over the
window's host seconds. Batch cells."""

from benchmark import readers


def read(run):
    return readers.mpix_per_s(run)
