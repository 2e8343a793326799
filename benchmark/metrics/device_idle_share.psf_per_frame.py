"""device_idle_share.psf_per_frame: the share of the measured window in which the
device ran nothing, % (readers.idle_share; moves frame_ms_p50.psf_per_frame)."""

from benchmark import readers


def read(run):
    return readers.idle_share(run)
