"""The port's SoA FFT API (fft_restoration_tpu_torch/ops/fft.py) against
the JAX package's (fft_restoration_tpu/ops/fft.py), backend for backend,
on the same numpy inputs (JAX on the CPU, its `pallas` backend in
interpret mode).

Tolerances, of the output's max magnitude: 1e-5 for radix2, xla and
pallas (the same stage arithmetic and tables, or two library FFTs);
1e-4 for matmul and naive, whose float32 matrix products sum in another
order than XLA's einsums. The host tables (DFT matrices, twiddles,
factor splits) are equal bit for bit. `_full_float32`'s TF32 flip is
checked under threads (the flag is a plain process-wide attribute in a
CPU build too).
"""

import os
import sys
import threading

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


class _OnCard:
    """Stands for a CUDA tensor: _full_float32 reads only `.device.type`."""

    device = torch.device("cuda")


def test_full_float32_two_threads_never_interleave():
    """Thread A is inside _full_float32 and waits; thread B tries to
    enter. B gets in only after A leaves, TF32 reads False whenever
    either is inside, and the flag is back to its first value after both
    have left (without the lock, A's exit would switch TF32 on under B)."""
    flag = torch.backends.cuda.matmul
    first = flag.allow_tf32
    flag.allow_tf32 = True
    a_inside, a_release, b_inside = threading.Event(), threading.Event(), threading.Event()
    seen = []

    def a():
        with tfft._full_float32(_OnCard()):
            seen.append(("a", flag.allow_tf32))
            a_inside.set()
            a_release.wait(timeout=30)
            seen.append(("a", flag.allow_tf32))

    def b():
        a_inside.wait(timeout=30)
        with tfft._full_float32(_OnCard()):
            b_inside.set()
            seen.append(("b", flag.allow_tf32))

    threads = [threading.Thread(target=a), threading.Thread(target=b)]
    try:
        for t in threads:
            t.start()
        assert a_inside.wait(timeout=30)
        assert not b_inside.wait(timeout=0.3), "B entered while A was inside"
        a_release.set()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert b_inside.is_set()
        assert seen == [("a", False), ("a", False), ("b", False)]
        assert flag.allow_tf32 is True
    finally:
        a_release.set()
        flag.allow_tf32 = first


def test_full_float32_stress_many_threads():
    """More threads than cores enter and leave _full_float32 with a short
    switch interval: none ever reads TF32 on inside, and the flag ends as
    it started. CPU tensors take the early return, without the lock."""
    flag = torch.backends.cuda.matmul
    first = flag.allow_tf32
    flag.allow_tf32 = True
    bad, switch = [], sys.getswitchinterval()

    def worker():
        for _ in range(200):
            with tfft._full_float32(_OnCard()):
                if flag.allow_tf32:
                    bad.append(1)

    threads = [threading.Thread(target=worker) for _ in range(2 * (os.cpu_count() or 4))]
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not bad and flag.allow_tf32 is True
        with tfft._full_float32(torch.zeros(1)):
            assert flag.allow_tf32 is True  # no flip for a CPU tensor
    finally:
        sys.setswitchinterval(switch)
        flag.allow_tf32 = first
