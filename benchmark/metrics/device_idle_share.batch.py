"""device_idle_share.batch: the share of the measured window in which the
device ran nothing, % (readers.idle_share; moves mpix_per_s)."""

from benchmark import readers


def read(run):
    return readers.idle_share(run)
