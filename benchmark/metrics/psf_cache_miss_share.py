"""psf_cache_miss_share: the program's PSF-cache misses over its lookups
in the traced slice's requests, % (100 by the per-frame PSF cell's
design: it guards that the miss path stays exercised; moves
frame_ms_p50.psf_per_frame)."""

from benchmark import program_spans


def read(run):
    return program_spans.psf_cache_miss_share(run)
