"""run_self_host_ms.stream: host ms a request inside the program's
frequest range and outside every fphase_ range in the traced slice: the
Python of the pipeline's run between its phases (moves frame_ms_p50)."""

from benchmark import program_spans


def read(run):
    return program_spans.run_self_host_ms(run)
