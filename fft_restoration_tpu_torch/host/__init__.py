"""Host-side numpy layer of the port: everything around the device path.

  padding   pow2 extents of a frame
  oracle    the serial numpy restore every device run is verified against,
            and its PSF family (the motion PSF with OpenCV
            getRotationMatrix2D + warpAffine semantics, gaussian, disk)
  psf_file  user PSF kernels from .npy/.txt/.csv arrays and 8-bit PNGs
  color     BGR <-> Lab and the white balance in numpy (the tiled
            restore's host stitch)
  taper     the edge-taper window, shared by the device taper and the
            oracle's (bit-identical coefficients on both sides)
  edgetaper the oracle's edge taper (float64 np.fft circular blur)
  blurgen   blurred test frames (the forward problem the restore inverts)
  verify    the reference's three tolerance tiers (l2, inf, gpu)
  imageio   image decode (PNG, BMP, PNM, PAM) as BGR uint8, PNG write
  formats   the BMP, PNM and PAM codecs

Counterparts of fft_restoration_tpu/utils/{padding,blurgen,verify,imageio,taper,formats}.py,
fft_restoration_tpu/oracle/{psf,serial,edgetaper,color}.py and ops/psf.py's
load_psf_file, kept to what the ported
slice uses, so that the port and its smoke run need nothing of the JAX
package. The oracle shares no code with the port's kernels or their
plain versions.
"""
