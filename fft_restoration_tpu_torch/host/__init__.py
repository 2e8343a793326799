"""Host-side numpy layer of the port: everything around the device path.

  padding   pow2 extents of a frame
  oracle    the serial numpy restore every device run is verified against,
            and its PSF family (the motion PSF with OpenCV
            getRotationMatrix2D + warpAffine semantics, gaussian, disk)
  psf_file  user PSF kernels from .npy/.txt/.csv arrays and images
  color     BGR <-> Lab and the white balance in numpy (the tiled
            restore's host stitch)
  taper     the edge-taper window, shared by the device taper and the
            oracle's (bit-identical coefficients on both sides)
  edgetaper the oracle's edge taper (float64 np.fft circular blur)
  blurgen   blurred test frames (the forward problem the restore inverts)
  verify    the reference's three tolerance tiers (l2, inf, gpu)
  imageio   image decode as BGR uint8 (PNG, and the formats below by
            their magic bytes), write by extension, size probe, batch read
  jpeg      baseline and progressive JPEG decode; jpeg_encode: baseline
  formats   BMP, PNM, PAM, PBM, TIFF, PFM, Radiance HDR, Sun Raster
  native    the C++ codec under imageio and jpeg (csrc/host/png_codec.cpp,
            built with g++ at first use)
  termview  the terminal preview of --show

Counterparts of fft_restoration_tpu/utils/{padding,blurgen,verify,imageio,taper,formats,
jpeg,jpeg_encode,termview}.py and native/png_codec.cpp,
fft_restoration_tpu/oracle/{psf,serial,edgetaper,color}.py and ops/psf.py's
load_psf_file, kept to what the ported
slice uses, so that the port and its smoke run need nothing of the JAX
package. The oracle shares no code with the port's kernels or their
plain versions.
"""
