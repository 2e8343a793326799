"""dispatch_ms.batch: host ms inside the pipeline's run call, no
synchronise, mean over the window's calls (moves mpix_per_s)."""

from benchmark import readers


def read(run):
    return readers.dispatch_ms(run)
