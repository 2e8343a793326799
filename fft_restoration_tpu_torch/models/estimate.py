"""Blind PSF and noise estimation from the blurred frame.

Counterpart of fft_restoration_tpu/models/estimate.py, function for
function, on the port's `ops/fft.fft2d` (default backend 'pallas': B6's
natural-order row FFT, launched twice per 2D transform):

  estimate_motion_psf    the cepstral method (Cannon 1976): a linear
                         motion blur of length L puts negative peaks into
                         C = IFFT(log |FFT(window * gray)|^2) at distance L
                         along the blur; (length, angle) from the argmin of
                         C over an annulus, the confidence a robust z-score
                         of that peak against the annulus' median and MAD.
  estimate_disk_psf      the radial cepstral profile's ring (defocus
                         diameter), with a sector-isotropy confidence.
  estimate_gaussian_psf  a scan of sigma candidates against the radial
                         log-power profile (power-law prior).
  estimate_noise_K       Immerkaer's stencil noise sigma, and the Wiener K
                         as the noise-to-signal power ratio.

On the device: the Hann window, the transforms, the log power, the
fftshift roll, the annulus selection, its medians and argmin, the
radial bin sums and the noise stencil; on the host, as in JAX, the 1D
analysis of the radial profiles. Where torch and jnp differ:

  * jnp.nanmedian interpolates the two middle values of an even count;
    torch.median takes the lower one. The annulus values are selected
    first (no NaN mask), then `_median` interpolates as jnp does (and no
    torch.quantile, which refuses more than 2^24 values: the 4096x6144
    frame's cepstrum has 2^25);
  * jnp.var is the population variance (torch.var's correction=0);
  * jax.ops.segment_sum is `index_add_` in float32 (the summation order
    differs on the card: profiles agree to float32 rounding);
  * argmin takes the first minimal index on both sides.

The JAX CLI sends 'pallas' estimation to 'matmul' (a TPU compile-time
choice); the port keeps the kernels (ROADMAP.md C).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from fft_restoration_tpu_torch.host.padding import next_power_of_two
from fft_restoration_tpu_torch.models.pipeline import KERNEL_BACKEND, resolve_device
from fft_restoration_tpu_torch.ops.fft import check_backend, fft2d

# confidence z-score below which the frame likely carries no linear
# motion blur (the JAX package's: sharp structured scene ~10, blurred 18-69)
CONF_WARN = 14.0
# first-zero offset of J1 (3.8317) against its asymptotic pi spacing: the
# ring sits at ~0.967 of the disk's diameter (JAX _DISK_RING_CAL)
DISK_RING_CAL = 0.967
# sector-isotropy z-score below which the frame likely carries no defocus
DISK_CONF_WARN = 6.0
# residual-ratio confidence below which a gaussian sigma is ambiguous
GAUSS_CONF_WARN = 1.3
GAUSS_SIGMA_GRID = np.geomspace(0.5, 16.0, 33)


def _median(v: torch.Tensor) -> torch.Tensor:
    """Median of a 1-D tensor, the two middle values interpolated for an
    even count (jnp.nanmedian's 'linear' quantile at 0.5)."""
    s = torch.sort(v).values
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return s[n // 2 - 1] * 0.5 + s[n // 2] * 0.5


def _gray(img, device) -> torch.Tensor:
    """(H, W, 3) or (H, W) frame -> (H, W) float32 gray on the device: the
    channel mean of the 0..255 values, divided truly (a CUDA tensor
    divided by a Python scalar is a reciprocal multiply)."""
    x = torch.from_numpy(np.ascontiguousarray(img)).to(device).to(torch.float32)
    if x.ndim == 3:
        x = x.sum(-1) / torch.full((), float(img.shape[-1]), device=device)
    return x


def _windowed(gray, hp: int, wp: int) -> torch.Tensor:
    """Mean-removed, Hann-windowed gray, zero padded to (hp, wp)."""
    h, w = gray.shape
    wy = torch.from_numpy(np.hanning(h).astype(np.float32)).to(gray.device)
    wx = torch.from_numpy(np.hanning(w).astype(np.float32)).to(gray.device)
    g = torch.zeros((hp, wp), dtype=torch.float32, device=gray.device)
    g[:h, :w] = (gray - gray.mean()) * wy[:, None] * wx[None, :]
    return g


def _log_power_cepstrum(g, backend, ops):
    """Power spectrum P of g, and the real cepstrum IFFT(log2(P + 1e-12))
    (log2: the same argmin as ln, as in JAX)."""
    f_re, f_im = fft2d(g, torch.zeros_like(g), False, backend, ops)
    p = f_re * f_re + f_im * f_im
    lp = torch.log2(p + 1e-12)
    c_re, _ = fft2d(lp, torch.zeros_like(lp), True, backend, ops)
    return p, c_re


@functools.lru_cache(maxsize=8)
def _annulus_mask(hp: int, wp: int, r_min: float, r_max: float) -> np.ndarray:
    yy, xx = np.mgrid[-(hp // 2): hp - hp // 2, -(wp // 2): wp - wp // 2]
    r = np.hypot(yy, xx)
    return (r >= r_min) & (r <= r_max)


def _cepstral_peak(gray, hp, wp, r_min, r_max, backend, ops):
    """(H, W) gray -> (flat argmin index over the shifted (hp, wp)
    cepstrum, peak value, annulus median, annulus MAD) as Python numbers."""
    _, c_re = _log_power_cepstrum(_windowed(gray, hp, wp), backend, ops)
    c = torch.roll(c_re, (hp // 2, wp // 2), dims=(0, 1))  # fftshift
    mask = torch.from_numpy(_annulus_mask(hp, wp, r_min, r_max)).to(c.device)
    cm = torch.where(mask, c, torch.full((), math.inf, device=c.device))
    idx = torch.argmin(cm)
    vals = c[mask]
    med = _median(vals)
    mad = _median(torch.abs(vals - med)) + 1e-12
    peak, med, mad = torch.stack([cm.reshape(-1)[idx], med, mad]).tolist()
    return int(idx), peak, med, mad


def estimate_motion_psf(img_bgr, *, fft_backend: str = KERNEL_BACKEND,
                        max_length: int | None = None, device="cuda", ops=None):
    """Estimate (length, angle_deg, confidence) of a linear motion blur
    from a blurred uint8 or float BGR (or gray) frame.

    length is in the CLI's psf-length units; angle in [0, 180) degrees,
    the CLI's convention (the PSF is symmetric: defined mod 180; image y
    points down, so the cepstral angle is mirrored). confidence is how
    many MAD-sigmas the cepstral peak sits below the annulus median
    (warn below CONF_WARN). The annulus spans radii 3 to min(h, w) // 3
    (and max_length). ops: for 'pallas', where the row FFT comes from
    (None: the kernel; models.pipeline.PLAIN_OPS: its plain version)."""
    img = np.asarray(img_bgr)
    check_backend(fft_backend)
    h, w = img.shape[:2]
    if min(h, w) < 12:
        # r_max = min(h, w) // 3 must clear r_min = 3 or the annulus is empty
        raise ValueError(f"image too small for blur estimation (min dim {min(h, w)} < 12)")
    hp, wp = next_power_of_two(h), next_power_of_two(w)
    r_max = float(min(min(h, w) // 3, max_length if max_length else 10**9))
    idx, peak, med, mad = _cepstral_peak(_gray(img, resolve_device(device)), hp, wp, 3.0,
                                         r_max, fft_backend, ops)
    iy, ix = np.unravel_index(idx, (hp, wp))
    dy, dx = iy - hp // 2, ix - wp // 2
    length = int(round(float(np.hypot(dy, dx))))
    angle = float((-np.degrees(np.arctan2(dy, dx))) % 180.0)
    conf = float((med - peak) / (1.4826 * mad))
    if not np.isfinite(conf):
        conf = 0.0  # a constant frame: no blur signal
    return length, angle, conf


# ---------------------------------------------------------------------------
# disk diameter and gaussian sigma: radially averaged statistics of the
# square pow2-padded, Hann-windowed frame (the device part), analysed in
# 1D on the host (verbatim the JAX package's method and constants)


@functools.lru_cache(maxsize=8)
def _radial_bin_map(n: int) -> tuple:
    """Radius-bin ids of the unshifted (n, n) DFT grid and per-bin counts."""
    d = np.minimum(np.arange(n), n - np.arange(n)).astype(np.float64)
    r = np.hypot(d[:, None], d[None, :])
    rbin = np.round(r).astype(np.int32)
    counts = np.bincount(rbin.ravel()).astype(np.float64)
    return rbin, counts


def _spectral_profiles(gray, fft_backend, ops):
    """Radial mean power profile S[rho], radial mean cepstrum c[rho], the
    bins' counts, the square pad size n (profiles cut to rho < n // 2)
    and the unshifted 2D cepstrum (float64, on the host)."""
    h, w = gray.shape
    n = next_power_of_two(max(h, w))
    p, c_re = _log_power_cepstrum(_windowed(gray, n, n), fft_backend, ops)
    rbin, counts = _radial_bin_map(n)
    seg = torch.from_numpy(rbin.reshape(-1).astype(np.int64)).to(p.device)
    sums = torch.zeros((2, len(counts)), dtype=torch.float32, device=p.device)
    sums[0].index_add_(0, seg, p.reshape(-1))
    sums[1].index_add_(0, seg, c_re.reshape(-1))
    s_sum, c_sum = sums.cpu().numpy().astype(np.float64)
    half = n // 2
    return (s_sum[:half] / counts[:half], c_sum[:half] / counts[:half], counts[:half], n,
            c_re.cpu().numpy().astype(np.float64))


def _to_gray(img_bgr, min_dim: int, device) -> torch.Tensor:
    img = np.asarray(img_bgr)
    if min(img.shape[:2]) < min_dim:
        raise ValueError(f"image too small for blur estimation (min dim "
                         f"{min(img.shape[:2])} < {min_dim})")
    return _gray(img, resolve_device(device))


def _sector_ring_conf(c2d: np.ndarray, n: int, ring_bin: int, r_hi: int,
                      nsec: int = 16) -> float:
    """The 25th percentile over nsec angular sectors of the cepstrum of
    each sector's z-score of the dip at ring_bin against its own robust
    band statistics: a defocus ring is deep in every direction, a
    directional texture or a motion blur in few."""
    k = np.arange(n)
    signed = np.where(k <= n // 2, k, k - n)
    th = np.arctan2(signed[:, None], signed[None, :]) % (2.0 * np.pi)
    sec = np.minimum((th / (2.0 * np.pi / nsec)).astype(np.int64), nsec - 1)
    rbin, _ = _radial_bin_map(n)
    nb = int(rbin.max()) + 1
    comb = (sec * nb + rbin).ravel()
    sums = np.bincount(comb, weights=c2d.ravel(), minlength=nsec * nb)
    cnts = np.bincount(comb, minlength=nsec * nb).astype(np.float64)
    prof = (sums / np.maximum(cnts, 1.0)).reshape(nsec, nb)
    zs = np.empty(nsec)
    for s in range(nsec):
        band = prof[s, 3: r_hi + 1]
        med = float(np.median(band))
        mad = float(np.median(np.abs(band - med))) + 1e-12
        lo = float(np.min(prof[s, max(ring_bin - 1, 0): ring_bin + 2]))
        zs[s] = (med - lo) / (1.4826 * mad)
    conf = float(np.percentile(zs, 25))
    return conf if np.isfinite(conf) else 0.0


def estimate_disk_psf(img_bgr, *, fft_backend: str = KERNEL_BACKEND,
                      max_size: int | None = None, device="cuda", ops=None):
    """Blind defocus-diameter estimation: (size, confidence). size is the
    disk diameter --psf-type disk takes as its psf-length; confidence the
    sector-isotropy z-score (warn below DISK_CONF_WARN). max_size bounds
    the ring search and the returned size."""
    check_backend(fft_backend)
    gray = _to_gray(img_bgr, 12, device)
    h, w = gray.shape
    _, cep, _, n, c2d = _spectral_profiles(gray, fft_backend, ops)
    r_hi = min(min(h, w) // 3, max_size if max_size else 10**9)
    if r_hi <= 4:
        raise ValueError("image too small for disk estimation")
    i = int(np.argmin(cep[3: r_hi + 1])) + 3
    # parabolic sub-bin refinement
    if 1 <= i < len(cep) - 1:
        y0, y1, y2 = cep[i - 1], cep[i], cep[i + 1]
        den = y0 - 2.0 * y1 + y2
        d = float(np.clip((y0 - y2) / (2.0 * den), -1, 1)) if den else 0.0
    else:
        d = 0.0
    size = max(3, int(round((i + d) / DISK_RING_CAL)))
    if max_size is not None:
        size = min(size, max_size)
    return size, _sector_ring_conf(c2d, n, i, r_hi)


def gaussian_ksize(sigma: float) -> int:
    """Kernel extent covering +-3 sigma (odd): the psf-length the CLI's
    gaussian family pairs with an estimated sigma."""
    return max(3, 2 * int(math.ceil(3.0 * float(sigma))) + 1)


def _huber_fit(A: np.ndarray, y: np.ndarray, w0: np.ndarray, iters: int = 4) -> tuple:
    """Weighted Huber regression: (coef, weighted mean-square residual)."""
    w = w0.copy()
    coef, *_ = np.linalg.lstsq(A * w[:, None], y * w, rcond=None)
    for _ in range(iters):
        r = y - A @ coef
        s = 1.4826 * np.median(np.abs(r)) + 1e-12
        hub = np.clip(1.345 * s / np.maximum(np.abs(r), 1e-12), 0.0, 1.0)
        w = w0 * hub
        coef, *_ = np.linalg.lstsq(A * w[:, None], y * w, rcond=None)
    r = y - A @ coef
    return coef, float(np.sum((w * r) ** 2) / np.sum(w * w))


def _gaussian_radial_log_mtf(sigma: float, n: int, rbin: np.ndarray,
                             counts_half: np.ndarray) -> np.ndarray:
    """Radial mean of ln|H|^2 of the truncated sampled gaussian kernel
    (ops/psf.gaussian_kernel's transfer function), separable."""
    ks = gaussian_ksize(sigma)
    x = np.arange(ks, dtype=np.float64) - (ks // 2)
    a = np.exp(-(x * x) / (2.0 * sigma * sigma))
    a = a / a.sum()
    lh1 = np.log(np.abs(np.fft.fft(a, n)) ** 2 + 1e-300)
    lm = lh1[:, None] + lh1[None, :]
    prof = np.bincount(rbin.ravel(), weights=lm.ravel())
    return prof[: n // 2] / counts_half


def estimate_gaussian_psf(img_bgr, *, fft_backend: str = KERNEL_BACKEND, device="cuda",
                          ops=None):
    """Blind gaussian-blur sigma estimation: (sigma, confidence). Each
    candidate of GAUSS_SIGMA_GRID's exact radial log-MTF is subtracted
    from the radial log-power profile and the remainder's power-law fit
    scored; confidence is the residual ratio no-blur / best (near 1: a
    smooth scene cannot tell blur from content; warn below
    GAUSS_CONF_WARN). Raises ValueError without a usable decay band."""
    check_backend(fft_backend)
    gray = _to_gray(img_bgr, 32, device)
    s, _, counts, n, _ = _spectral_profiles(gray, fft_backend, ops)
    half = n // 2
    rho = np.arange(half, dtype=np.float64)
    floor = float(np.median(s[int(0.85 * half):]))
    t = s - floor
    idx = np.where((t > 3.0 * floor) & (rho >= 3))[0]
    if len(idx) < 10:
        raise ValueError("no usable spectral decay band (flat or floor-dominated "
                         "spectrum); cannot estimate a gaussian blur")
    # the leading contiguous run (gaps <= 4 merged): the main signal lobe
    runs = np.split(idx, np.where(np.diff(idx) > 3)[0] + 1)
    band = runs[0]
    for r in runs[1:]:
        if band[-1] + 4 >= r[0]:
            band = np.concatenate([band, r])
    y = np.log(t[band])
    w0 = np.sqrt(counts[band])
    A = np.stack([np.ones(len(band)), np.log(rho[band])], axis=-1)
    _, resid0 = _huber_fit(A, y, w0)
    rbin, _ = _radial_bin_map(n)
    resids = np.empty(len(GAUSS_SIGMA_GRID))
    for j, sc in enumerate(GAUSS_SIGMA_GRID):
        mtf = _gaussian_radial_log_mtf(float(sc), n, rbin, counts)
        _, resids[j] = _huber_fit(A, y - mtf[band], w0)
    i = int(np.argmin(resids))
    # parabolic refinement in log-sigma
    if 0 < i < len(GAUSS_SIGMA_GRID) - 1:
        l0, l1 = np.log(GAUSS_SIGMA_GRID[i - 1: i + 1])
        r0, r1, r2 = resids[i - 1: i + 2]
        den = r0 - 2.0 * r1 + r2
        d = float(np.clip(0.5 * (r0 - r2) / den, -1, 1)) if den else 0.0
        sigma = float(np.exp(l1 + d * (l1 - l0)))
    else:
        sigma = float(GAUSS_SIGMA_GRID[i])
    conf = float(resid0 / (resids[i] + 1e-30))
    return sigma, (conf if np.isfinite(conf) else 0.0)


def _noise_stats(gray: torch.Tensor) -> tuple:
    """(H, W) float32 in [0, 1] -> (noise sigma, population variance):
    Immerkaer's 3x3 mask [[1,-2,1],[-2,4,-2],[1,-2,1]] annihilates
    locally linear structure, and for gaussian noise sigma =
    sqrt(pi/2) * mean|I*N| / 6 (PRL 1996)."""
    c = gray[1:-1, 1:-1]
    u, d = gray[:-2, 1:-1], gray[2:, 1:-1]
    l, r = gray[1:-1, :-2], gray[1:-1, 2:]
    ul, ur = gray[:-2, :-2], gray[:-2, 2:]
    dl, dr = gray[2:, :-2], gray[2:, 2:]
    lap = 4.0 * c - 2.0 * (u + d + l + r) + (ul + ur + dl + dr)
    sigma = float(np.sqrt(np.float32(np.pi / 2.0))) * torch.abs(lap).mean() / 6.0
    var = torch.var(gray, correction=0)
    return tuple(torch.stack([sigma, var]).tolist())


def estimate_noise_K(img_bgr, *, k_min: float = 1e-4, k_max: float = 0.5, device="cuda"):
    """Noise-adaptive Wiener regularization: (sigma, K) with sigma the
    Immerkaer noise estimate of the gray frame in [0, 1] and K = sigma^2
    / max(var - sigma^2, 1e-8), clamped to [k_min, k_max] and rounded to
    2 significant digits. uint8 or float BGR/gray frames."""
    img = np.asarray(img_bgr)
    if min(img.shape[:2]) < 3:
        raise ValueError(f"image too small for noise estimation (min dim "
                         f"{min(img.shape[:2])} < 3)")
    gray = _gray(img, resolve_device(device))
    if img.dtype == np.uint8:
        gray = gray / torch.full((), 255.0, device=gray.device)
    sigma, var = _noise_stats(gray)
    k = (sigma * sigma) / max(var - sigma * sigma, 1e-8)
    k = min(max(k, k_min), k_max)
    k = round(k, 1 - math.floor(math.log10(k)))
    return sigma, float(k)
