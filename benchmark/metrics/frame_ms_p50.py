"""frame_ms_p50: median latency of all of the window's requests
(CUDA events around each run call). The 4K stream with a cached PSF."""

from benchmark import readers


def read(run):
    return readers.latency_ms(run, 50)
