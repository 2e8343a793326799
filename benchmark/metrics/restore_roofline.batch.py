"""restore_roofline.batch: the restore's least time (roofline/counts.py)
over device busy in the traced slice, % (moves mpix_per_s)."""

from benchmark import readers


def read(run):
    return readers.roofline(run)
