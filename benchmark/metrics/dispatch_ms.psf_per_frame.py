"""dispatch_ms.psf_per_frame: host ms inside the pipeline's run call, no
synchronise, mean over the window's calls (moves frame_ms_p50.psf_per_frame)."""

from benchmark import readers


def read(run):
    return readers.dispatch_ms(run)
