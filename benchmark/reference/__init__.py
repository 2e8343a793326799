"""The plain float64 references the benchmark holds the outputs against.

A configuration names its reference with `"reference": "<name>"`, the
module `<name>.py` here; without the key it is `restore.py`, the pow2
Wiener restore. The harness loads the module by its path
(`spec.reference`), and a module is a reference when it has:

  prepare(length, angle, h, w, config, device)
      what every (h, w) frame of the PSF (length, angle) reuses, such as
      the PSF's spectrum; the check makes it once a PSF and shape
  restore(frame, prepared, config)
      the uint8 (h, w, 3) BGR frame on `device` -> the reference's
      restored uint8 (h, w, 3) BGR frame

It reads its options (K, filter, iterations, pad, taper) from the
configuration it is given, works in float64, imports neither JAX, the
JAX package nor the program, and may import its siblings' float64
helpers relatively (`from .restore import encode, motion_psf`).
"""
