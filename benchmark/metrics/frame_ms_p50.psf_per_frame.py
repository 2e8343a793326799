"""frame_ms_p50.psf_per_frame: median latency of all of the
window's requests, each with a PSF of its own (a cell of its own: host-paced,
it spreads too widely to share frame_ms_p50's bound)."""

from benchmark import readers


def read(run):
    return readers.latency_ms(run, 50)
