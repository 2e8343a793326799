"""dispatch_ms.stream: host ms inside the pipeline's run call, no
synchronise, mean over the window's calls (moves frame_ms_p50)."""

from benchmark import readers


def read(run):
    return readers.dispatch_ms(run)
