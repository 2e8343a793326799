"""The plain versions of the ops layer's kernels against their JAX twins
(Pallas in interpret mode on the CPU): B9 `wiener_elem` (wiener_pallas),
B10 `wiener_spectral_rows` (wiener_spectral_rows_pallas), B11 `fft_cols`
(fft_cols_pallas), B12 `fft_rows_radix4_fwd` and B6's natural ordering
(`fft_rows(..., ordering="natural")`, fft_rows_pallas(ordering="natural")).
On CPU tensors each wrapper takes its plain version, so the wrappers are
what these tests call.

Tolerances: 1e-5 of the output's max magnitude (float32, the same
tables and operation order; the XLA CPU compiler may contract or reorder
within an expression), the elementwise Wiener filter 1e-6.
"""

import numpy as np
import pytest
import torch

from fft_restoration_tpu.ops.pallas import fft_radix4 as jr4
from fft_restoration_tpu.ops.pallas.fft_kernel import fft_cols_pallas, fft_rows_pallas
from fft_restoration_tpu.ops.pallas.wiener import wiener_pallas
from fft_restoration_tpu.ops.pallas.wiener_spectral import wiener_spectral_rows_pallas
from fft_restoration_tpu_torch.ops import kernels
from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk
from fft_restoration_tpu_torch.ops.kernels import fft_radix4 as tr4

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores


def _f32(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _rel(ours, ref):
    ref = [np.asarray(r) for r in ref]
    scale = max(np.abs(r).max() for r in ref)
    return max(np.abs(np.asarray(o) - r).max() for o, r in zip(ours, ref)) / scale


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_public_names_and_counters():
    for name in ("fft_rows", "fft_cols", "fft_rows_radix4_fwd", "wiener_elem",
                 "wiener_spectral_rows", "lab_l_sum_partials", "wb_encode_u8"):
        assert callable(getattr(kernels, name))
    assert {"fft_rows_natural", "fft_cols", "wiener_elem", "wiener_spectral_rows",
            "fft_rows_radix4"} <= set(kernels.KERNELS)
    with pytest.raises(AttributeError):
        kernels.not_a_kernel  # noqa: B018


@pytest.mark.parametrize("shape", [(3, 64, 128), (2, 2, 16, 8), (64, 128)])
def test_wiener_elem_matches_jax(shape):
    rng = np.random.default_rng(1)
    gr, gi = _f32(rng, shape), _f32(rng, shape)
    hr, hi = _f32(rng, shape[-2:]), _f32(rng, shape[-2:])
    ref = wiener_pallas((gr, gi), (hr, hi), 0.01)
    ours = kernels.wiener_elem(*_t(gr, gi, hr, hi), 0.01)
    assert ours[0].shape == shape and _rel(ours, ref) <= 1e-6


def test_wiener_elem_rejects_bad_operands():
    g = torch.zeros(2, 8, 8)
    with pytest.raises(ValueError, match="doesn't match"):
        kernels.wiener_elem(g, g, torch.zeros(8, 4), torch.zeros(8, 4), 0.01)
    with pytest.raises(ValueError, match="float32"):
        kernels.wiener_elem(g.double(), g.double(), g[0], g[0], 0.01)


@pytest.mark.parametrize("shape", [(3, 128, 128), (2, 100, 64)])
def test_wiener_spectral_rows_matches_jax(shape):
    rng = np.random.default_rng(2)
    ar, ai = _f32(rng, shape), _f32(rng, shape)
    hr, hi = _f32(rng, shape[-2:]), _f32(rng, shape[-2:])
    ref = wiener_spectral_rows_pallas((ar, ai), (hr, hi), 0.01)
    for rows in (None, 1, 8):
        ours = kernels.wiener_spectral_rows(*_t(ar, ai, hr, hi), 0.01, rows=rows)
        assert ours[0].shape == shape and _rel(ours, ref) <= 1e-5


def test_wiener_spectral_rows_rejects_bad_operands():
    a, h = torch.zeros(2, 8, 12), torch.zeros(8, 12)
    with pytest.raises(ValueError, match="power-of-two"):
        kernels.wiener_spectral_rows(a, a, h, h, 0.01)
    a, h = torch.zeros(2, 8, 16), torch.zeros(8, 16)
    for rows in (3, 32):
        with pytest.raises(ValueError, match="rows per block"):
            kernels.wiener_spectral_rows(a, a, h, h, 0.01, rows=rows)
    with pytest.raises(ValueError, match="does not match"):
        kernels.wiener_spectral_rows(a, a, h[:4], h[:4], 0.01)


@pytest.mark.parametrize("ordering", ["natural", "revorder"])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("h,w", [(2, 8), (8, 37), (128, 64), (128, 5)])
def test_fft_cols_matches_jax(h, w, inverse, ordering):
    rng = np.random.default_rng(h + w)
    re, im = _f32(rng, (2, h, w)), _f32(rng, (2, h, w))
    ref = fft_cols_pallas(re, im, inverse, ordering=ordering)
    ours = kernels.fft_cols(*_t(re, im), inverse=inverse, ordering=ordering)
    assert ours[0].shape == (2, h, w) and _rel(ours, ref) <= 1e-5


def test_fft_cols_strips_and_errors():
    # strips: 8 columns at H = 2048, 4 at 4096, at most 32, at most the
    # next power of two of W
    assert [fk.cols_per_block(h, w) for h, w in
            ((2048, 2048), (4096, 4096), (128, 37), (8, 3), (16384, 8))] == [8, 4, 32, 4, 1]
    x = torch.zeros(2, 12, 8)
    with pytest.raises(ValueError, match="power-of-two height"):
        kernels.fft_cols(x, x)
    with pytest.raises(ValueError, match="unknown ordering"):
        kernels.fft_cols(x[:, :8], x[:, :8], ordering="hybrid")
    one = torch.ones(3, 1, 5)
    assert kernels.fft_cols(one, one)[0] is one  # H = 1: the identity, as in JAX


@pytest.mark.parametrize("inverse", [False, True])
def test_transpose_free_fft2(inverse):
    """fft_rows(natural) then fft_cols(natural) is the 2D DFT, with no
    transpose (the JAX kernels' pairing)."""
    rng = np.random.default_rng(4)
    re, im = _f32(rng, (2, 64, 32)), _f32(rng, (2, 64, 32))
    r = kernels.fft_rows(*_t(re, im), inverse=inverse, ordering="natural")
    ours = kernels.fft_cols(*r, inverse=inverse, ordering="natural")
    z = re.astype(np.float64) + 1j * im
    want = np.fft.ifft2(z) * z[0].size if inverse else np.fft.fft2(z)
    assert _rel(ours, (want.real, want.imag)) <= 1e-5


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [2, 16, 256])
def test_fft_rows_natural_matches_jax(n, inverse):
    rng = np.random.default_rng(n)
    re, im = _f32(rng, (2, 8, n)), _f32(rng, (2, 8, n))
    ref = fft_rows_pallas(re, im, inverse, ordering="natural")
    ours = kernels.fft_rows(*_t(re, im), inverse=inverse, ordering="natural")
    assert _rel(ours, ref) <= 1e-5
    z = re.astype(np.float64) + 1j * im
    want = np.fft.ifft(z) * n if inverse else np.fft.fft(z)
    assert _rel(ours, (want.real, want.imag)) <= 1e-5


def test_fft_rows_natural_refuses_radices():
    x = torch.zeros(1, 2, 384)
    with pytest.raises(ValueError, match="revorder"):
        kernels.fft_rows(x, x, radices=(3,), ordering="natural")
    with pytest.raises(ValueError, match="unknown ordering"):
        kernels.fft_rows(x[..., :256], x[..., :256], ordering="hybrid")


@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("n", [16, 32, 128])
def test_radix4_matches_jax(n, real):
    rng = np.random.default_rng(n + real)
    re, im = _f32(rng, (3, 5, n)), None if real else _f32(rng, (3, 5, n))
    ref = jr4.fft_rows_radix4_fwd(re, im)
    ours = kernels.fft_rows_radix4_fwd(torch.from_numpy(re),
                                       None if real else torch.from_numpy(im))
    assert ours[0].shape == (3, 5, n) and _rel(ours, ref) <= 1e-5
    # against the numpy simulation of the stage math, and in FFT order
    # through the permutation (the JAX module's own checks)
    sim = tr4._numpy_sim(re.reshape(-1, n), None if real else im.reshape(-1, n))
    assert _rel([o.reshape(-1, n) for o in ours], sim) <= 1e-5
    perm = tr4.radix4_output_permutation(n)
    np.testing.assert_array_equal(perm, jr4.radix4_output_permutation(n))
    z = np.fft.fft(re.astype(np.float64) + (0 if real else 1j * im.astype(np.float64)))
    assert _rel(ours, (z.real[..., perm], z.imag[..., perm])) <= 1e-5


def test_radix4_errors():
    with pytest.raises(ValueError, match="power-of-two"):
        kernels.fft_rows_radix4_fwd(torch.zeros(2, 12))
    with pytest.raises(ValueError, match="n >= 4"):
        kernels.fft_rows_radix4_fwd(torch.zeros(2, 2))
