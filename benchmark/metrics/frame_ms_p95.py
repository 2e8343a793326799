"""frame_ms_p95: 95th percentile (nearest rank) of the latency
of all of the window's requests. The 4K stream with a cached PSF."""

from benchmark import readers


def read(run):
    return readers.latency_ms(run, 95)
