"""make_psf_device_ms: device ms a request of the rows launched under the
fphase_make_psf range (make_psf's small ops) in the traced slice (moves
frame_ms_p50.psf_per_frame)."""

from benchmark import program_spans


def read(run):
    return program_spans.make_psf_device_ms(run)
