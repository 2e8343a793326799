"""BGR <-> CIELAB and the Lab white balance in numpy (the host stitch's).

Counterpart of fft_restoration_tpu/oracle/color.py, bit for bit: OpenCV's
float COLOR_BGR2Lab / COLOR_Lab2BGR semantics (exact analytic sRGB
companding, D65 white, L in [0, 100]) in float64, and applyWhiteBalance
(scale L by mean(L_orig) / (mean(L_deblur) + 1e-6), clamp to [0, 100]).
The tiled restore's host-stitch path (models/tiled.py) white-balances
the stitched frame with it.
"""

from __future__ import annotations

import numpy as np

# sRGB -> XYZ (D65), rows scaled by the white point so that
# (X/Xn, Y/Yn, Z/Zn) comes straight out of the product, as OpenCV does
_SRGB2XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float64,
)
_D65 = np.array([0.950456, 1.0, 1.088754], dtype=np.float64)
_SRGB2XYZ_N = _SRGB2XYZ / _D65[:, None]
_XYZ2SRGB = np.linalg.inv(_SRGB2XYZ)

_T0 = 0.008856
_CBRT_A = 7.787
_CBRT_B = 16.0 / 116.0


def _srgb_to_linear(x: np.ndarray) -> np.ndarray:
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def _linear_to_srgb(x: np.ndarray) -> np.ndarray:
    x = np.clip(x, 0.0, None)
    return np.where(x <= 0.0031308, 12.92 * x, 1.055 * x ** (1.0 / 2.4) - 0.055)


def _f_cbrt(t: np.ndarray) -> np.ndarray:
    return np.where(t > _T0, np.cbrt(t), _CBRT_A * t + _CBRT_B)


def bgr_to_lab(img_bgr: np.ndarray) -> np.ndarray:
    """float BGR in [0, 1], shape (..., 3) -> Lab (L in [0, 100]), float32."""
    bgr = np.asarray(img_bgr, dtype=np.float64)
    rgb = bgr[..., ::-1]
    lin = _srgb_to_linear(np.clip(rgb, 0.0, 1.0))
    t = lin @ _SRGB2XYZ_N.T
    f = _f_cbrt(t)
    fy = f[..., 1]
    L = np.where(t[..., 1] > _T0, 116.0 * fy - 16.0, 903.3 * t[..., 1])
    a = 500.0 * (f[..., 0] - fy)
    b = 200.0 * (fy - f[..., 2])
    return np.stack([L, a, b], axis=-1).astype(np.float32)


def lab_to_bgr(lab: np.ndarray) -> np.ndarray:
    """Lab (L in [0, 100]) -> float BGR in [0, 1], shape (..., 3), float32."""
    lab = np.asarray(lab, dtype=np.float64)
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0

    def _inv_f(f: np.ndarray) -> np.ndarray:
        f3 = f ** 3
        return np.where(f3 > _T0, f3, (f - _CBRT_B) / _CBRT_A)

    t = np.stack([_inv_f(fx), _inv_f(fy), _inv_f(fz)], axis=-1)
    lin = (t * _D65) @ _XYZ2SRGB.T
    rgb = np.clip(_linear_to_srgb(lin), 0.0, 1.0)
    return rgb[..., ::-1].astype(np.float32)


def apply_white_balance(lab_deblur: np.ndarray, lab_orig: np.ndarray) -> np.ndarray:
    """Scale the deblurred L channel by mean(L_orig) / (mean(L_deblur) +
    1e-6) and clamp it to [0, 100] (the reference's applyWhiteBalance)."""
    lab = np.array(lab_deblur, dtype=np.float32, copy=True)
    avg_orig = float(np.mean(np.asarray(lab_orig, np.float64)[..., 0]))
    avg_deblur = float(np.mean(np.asarray(lab_deblur, np.float64)[..., 0]))
    gain = np.float32(avg_orig / (avg_deblur + 1e-6))
    lab[..., 0] = np.clip(lab[..., 0] * gain, np.float32(0.0), np.float32(100.0))
    return lab
