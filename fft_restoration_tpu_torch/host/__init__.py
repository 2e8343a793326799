"""Host-side numpy layer of the port: everything around the device path.

  padding   pow2 extents of a frame
  oracle    the serial numpy restore every device run is verified against,
            and its motion PSF (OpenCV getRotationMatrix2D + warpAffine
            semantics)
  blurgen   blurred test frames (the forward problem the restore inverts)
  verify    the reference's three tolerance tiers (l2, inf, gpu)
  imageio   PNG read/write as BGR uint8

Counterparts of fft_restoration_tpu/utils/{padding,blurgen,verify,imageio}.py
and fft_restoration_tpu/oracle/{psf,serial}.py, kept to what the ported
slice uses, so that the port and its smoke run need nothing of the JAX
package. The oracle shares no code with the port's kernels or their
plain versions.
"""
