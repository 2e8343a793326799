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
  formats   BMP, PNM, PAM, PBM, TIFF, PFM, Radiance HDR, Sun Raster, and
            the dispatch to the four below
  fax       CCITT MH/G3/G4 decode of TIFF strips (compressions 2-4)
  webp      WebP decode (VP8L, ALPH, VP8X; webp_vp8: VP8 key frames,
            _vp8_tables: its spec tables); webp_encode: lossless VP8L
  gif       GIF decode (first frame) and encode
  jp2       JPEG 2000 decode (jp2_t1: Tier-1); jp2_encode: lossless 5/3
  exr       OpenEXR decode and encode, scanline and tiled (exr_piz,
            exr_pxr24, exr_b44: those compressions both ways; exr_dwa:
            DWAA/DWAB decode)
  native    the C++ codec libraries under them (csrc/host/png_codec.cpp,
            webp_codec.cpp, gif_codec.cpp, jp2_t1.cpp), each built with
            g++ at first use
  termview  the terminal preview of --show

Counterparts of fft_restoration_tpu/utils/{padding,blurgen,verify,imageio,taper,formats,
jpeg,jpeg_encode,termview,webp,webp_vp8,webp_encode,_vp8_tables,gif,jp2,jp2_t1,
jp2_encode,fax,exr,exr_piz,exr_pxr24,exr_b44,exr_dwa}.py and native/{png_codec,webp_codec,gif_codec,jp2_t1}.cpp,
fft_restoration_tpu/oracle/{psf,serial,edgetaper,color}.py and ops/psf.py's
load_psf_file, kept to what the ported
slice uses, so that the port and its smoke run need nothing of the JAX
package. The oracle shares no code with the port's kernels or their
plain versions.
"""
