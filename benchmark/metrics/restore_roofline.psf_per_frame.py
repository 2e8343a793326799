"""restore_roofline.psf_per_frame: the restore's least time (roofline/counts.py)
over device busy in the traced slice, % (moves frame_ms_p50.psf_per_frame)."""

from benchmark import readers


def read(run):
    return readers.roofline(run)
