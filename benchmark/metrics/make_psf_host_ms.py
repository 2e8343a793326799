"""make_psf_host_ms: host ms a request inside the program's
fphase_make_psf range in the traced slice, from its in-memory records
(moves frame_ms_p50.psf_per_frame)."""

from benchmark import program_spans


def read(run):
    return program_spans.make_psf_host_ms(run)
