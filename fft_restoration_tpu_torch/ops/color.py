"""Planar BGR <-> CIELAB on (H, W) float32 tensors.

Counterpart of fft_restoration_tpu/ops/color.py's planar functions
(bgr_to_lab_planar, lab_to_bgr_planar, luminance_l_planar): exact
analytic sRGB companding, D65 white, L in [0, 100], the cv2-parity
formulas of the oracle. Every power goes as exp2(log2(max(x, 1e-30))*p),
expression for expression as the JAX package and its post-processing
kernels compute it. These are the plain versions behind the white
balance kernels (ops/kernels/postprocess.py). The transcendental-free
`*_fast` forms are not ported (a measured negative on the TPU).
"""

from __future__ import annotations

import numpy as np
import torch

_T0 = 0.008856
_CBRT_A = 7.787
_CBRT_B = 16.0 / 116.0

# sRGB -> XYZ (D65), rows scaled by the white point so that
# (X/Xn, Y/Yn, Z/Zn) comes straight out of the product, as OpenCV does;
# built in float64, then rounded to float32 as the kernels multiply them
_SRGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                      [0.212671, 0.715160, 0.072169],
                      [0.019334, 0.119193, 0.950227]])
_D65 = np.array([0.950456, 1.0, 1.088754])
M_SRGB2XYZ = [[float(v) for v in row] for row in (_SRGB2XYZ / _D65[:, None]).astype(np.float32)]
M_XYZ2SRGB = [[float(v) for v in row] for row in np.linalg.inv(_SRGB2XYZ).astype(np.float32)]
D65 = [float(v) for v in _D65.astype(np.float32)]


def _pow_pos(x, p):
    return torch.exp2(torch.log2(torch.clamp(x, min=1e-30)) * p)


def _srgb_to_linear(x):
    return torch.where(x <= 0.04045, x / 12.92, _pow_pos((x + 0.055) / 1.055, 2.4))


def _linear_to_srgb(x):
    x = torch.clamp(x, min=0.0)
    return torch.where(x <= 0.0031308, 12.92 * x, 1.055 * _pow_pos(x, 1.0 / 2.4) - 0.055)


def _f_cbrt(t):
    return torch.where(t > _T0, _pow_pos(t, 1.0 / 3.0), _CBRT_A * t + _CBRT_B)


def _linear_bgr(b, g, r):
    return tuple(
        _srgb_to_linear(torch.clamp(c.to(torch.float32), 0.0, 1.0)) for c in (b, g, r)
    )


def bgr_to_lab_planar(b, g, r):
    """(H, W) float BGR planes in [0,1] -> (L, a, b) float32 planes."""
    m = M_SRGB2XYZ
    lb, lg, lr = _linear_bgr(b, g, r)
    # rgb-ordered rows applied to bgr planes
    tx = m[0][2] * lb + m[0][1] * lg + m[0][0] * lr
    ty = m[1][2] * lb + m[1][1] * lg + m[1][0] * lr
    tz = m[2][2] * lb + m[2][1] * lg + m[2][0] * lr
    fx, fy, fz = _f_cbrt(tx), _f_cbrt(ty), _f_cbrt(tz)
    L = torch.where(ty > _T0, 116.0 * fy - 16.0, 903.3 * ty)
    return L, 500.0 * (fx - fy), 200.0 * (fy - fz)


def luminance_l_planar(b, g, r):
    """Lab L plane only (the white-balance gain's input)."""
    m = M_SRGB2XYZ
    lb, lg, lr = _linear_bgr(b, g, r)
    y = m[1][2] * lb + m[1][1] * lg + m[1][0] * lr
    return torch.where(y > _T0, 116.0 * _f_cbrt(y) - 16.0, 903.3 * y)


def lab_to_bgr_planar(L, a, b):
    """(L, a, b) planes -> (b, g, r) float32 planes in [0,1]."""
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0

    def _inv_f(f):
        f3 = f * f * f
        return torch.where(f3 > _T0, f3, (f - _CBRT_B) / _CBRT_A)

    x = _inv_f(fx) * D65[0]
    y = _inv_f(fy) * D65[1]
    z = _inv_f(fz) * D65[2]
    m = M_XYZ2SRGB
    lr = m[0][0] * x + m[0][1] * y + m[0][2] * z
    lg = m[1][0] * x + m[1][1] * y + m[1][2] * z
    lb = m[2][0] * x + m[2][1] * y + m[2][2] * z
    return tuple(torch.clamp(_linear_to_srgb(v), 0.0, 1.0) for v in (lb, lg, lr))
