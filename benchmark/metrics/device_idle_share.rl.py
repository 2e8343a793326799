"""device_idle_share.rl: the share of the measured window in which the
device ran nothing, % (readers.idle_share; moves frame_ms_p50)."""

from benchmark import readers


def read(run):
    return readers.idle_share(run)
