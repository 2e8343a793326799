"""The port's SoA FFT API (fft_restoration_tpu_torch/ops/fft.py) against
the JAX package's (fft_restoration_tpu/ops/fft.py), backend for backend,
on the same numpy inputs (JAX on the CPU, its `pallas` backend in
interpret mode).

Tolerances, of the output's max magnitude: 1e-5 for radix2, xla and
pallas (the same stage arithmetic and tables, or two library FFTs);
1e-4 for matmul and naive, whose float32 matrix products sum in another
order than XLA's einsums. The host tables (DFT matrices, twiddles,
factor splits) are equal bit for bit.
"""

import numpy as np
import pytest
import torch

from fft_restoration_tpu.ops import fft as jfft
from fft_restoration_tpu_torch.ops import fft as tfft

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

BACKENDS = ("radix2", "matmul", "naive", "xla", "pallas")
TOL = {"radix2": 1e-5, "xla": 1e-5, "pallas": 1e-5, "matmul": 1e-4, "naive": 1e-4}


def _planes(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _rel(ours, ref):
    ref = [np.asarray(r) for r in ref]
    scale = max(np.abs(r).max() for r in ref)
    return max(np.abs(o.numpy() - r).max() for o, r in zip(ours, ref)) / scale


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [2, 8, 64, 512])
@pytest.mark.parametrize("backend", BACKENDS)
def test_fft1d_matches_jax(backend, n, inverse):
    re, im = _planes(n, (3, n))
    ref = jfft.fft1d(re, im, inverse, backend)
    ours = tfft.fft1d(torch.from_numpy(re), torch.from_numpy(im), inverse, backend)
    assert all(o.shape == (3, n) and o.dtype == torch.float32 for o in ours)
    assert _rel(ours, ref) <= TOL[backend]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
def test_fft2d_matches_jax(backend, inverse):
    re, im = _planes(5, (2, 16, 32))
    ref = jfft.fft2d(re, im, inverse, backend)
    ours = tfft.fft2d(torch.from_numpy(re), torch.from_numpy(im), inverse, backend)
    assert _rel(ours, ref) <= TOL[backend]
    # and the transform itself (float64 numpy, unscaled inverse)
    z = re.astype(np.float64) + 1j * im
    want = np.fft.ifft2(z) * 16 * 32 if inverse else np.fft.fft2(z)
    assert _rel(ours, (want.real, want.imag)) <= TOL[backend]


@pytest.mark.parametrize("n", [6, 30, 97, 384])
@pytest.mark.parametrize("backend", BACKENDS)
def test_non_pow2_lengths(backend, n):
    """radix2 and pallas fall back to the naive DFT matmul at a non-pow2
    n (bit for bit the port's naive backend); matmul runs its four-step on
    a composite n and the naive matmul on a prime one; all match JAX."""
    re, im = _planes(n + 1, (2, n))
    t_re, t_im = torch.from_numpy(re), torch.from_numpy(im)
    ours = tfft.fft1d(t_re, t_im, False, backend)
    assert _rel(ours, jfft.fft1d(re, im, False, backend)) <= 1e-4
    if backend in ("radix2", "pallas"):
        naive = tfft.fft1d(t_re, t_im, False, "naive")
        assert all(torch.equal(o, r) for o, r in zip(ours, naive))


@pytest.mark.parametrize("backend", BACKENDS)
def test_inverse_is_unscaled(backend):
    re, im = _planes(3, (4, 64))
    fwd = tfft.fft1d(torch.from_numpy(re), torch.from_numpy(im), False, backend)
    back = tfft.fft1d(*fwd, True, backend)
    assert _rel([b / 64 for b in back], (re, im)) <= 10 * TOL[backend]


def test_unknown_backend_and_shape_errors():
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="unknown fft backend"):
        tfft.fft1d(x, x, backend="cufft")
    with pytest.raises(ValueError, match="shape mismatch"):
        tfft.fft1d(x, torch.zeros(4))
    assert tfft.FFT_BACKENDS == jfft.FFT_BACKENDS


def test_host_tables_match_jax():
    for n in (2, 3, 8, 60, 64, 97, 2304, 3840):
        assert tfft._split_factors(n) == jfft._split_factors(n)
    for n in (2, 5, 16, 60):
        for inv in (False, True):
            for ours, ref in zip(tfft._dft_matrix_np(n, inv), jfft._dft_matrix_np(n, inv)):
                np.testing.assert_array_equal(ours, ref)
            for ours, ref in zip(tfft._stage_twiddle_np(2 * n, inv),
                                 jfft._stage_twiddle_np(2 * n, inv)):
                np.testing.assert_array_equal(ours, ref)
            for ours, ref in zip(tfft._four_step_twiddle_np(n, 8, inv),
                                 jfft._four_step_twiddle_np(n, 8, inv)):
                np.testing.assert_array_equal(ours, ref)


def test_bit_reversal_matches_jax():
    x = np.arange(2 * 64, dtype=np.float32).reshape(2, 64)
    np.testing.assert_array_equal(tfft.bit_reverse_last_axis(torch.from_numpy(x)).numpy(),
                                  np.asarray(jfft._bit_reverse_last_axis(x)))
