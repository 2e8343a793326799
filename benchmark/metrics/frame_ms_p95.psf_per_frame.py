"""frame_ms_p95.psf_per_frame: 95th percentile (nearest rank) of
the latency of all of the window's requests, each with a PSF of its own."""

from benchmark import readers


def read(run):
    return readers.latency_ms(run, 95)
