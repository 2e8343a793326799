"""Port row-FFT family (B1/B3/B6) against the JAX Pallas kernels.

The JAX side runs in interpret mode on the CPU with engine="roll" and
ordering="revorder" — the pure radix-2 stages whose spectra the port
reproduces (plain bit-reversed order). The port side runs its plain
versions: the wrappers take them for CPU tensors. Tolerance: max error
<= 1e-5 of the plane's max magnitude (float32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_restoration_tpu.ops.pallas import fft_kernel as jfk
from fft_restoration_tpu_torch.ops.kernels import fft_kernel as tfk

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

REL = 1e-5


def _close(ours, ref):
    ours = np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(ours - ref).max()) <= REL * scale


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("n", [2, 8, 128, 512])
def test_tables_match_jax(n):
    for inverse in (False, True):
        for a, b in zip(tfk._twiddle_planes_np(n, inverse), jfk._twiddle_planes_np(n, inverse)):
            assert np.array_equal(a, b)
    assert np.array_equal(tfk._half_masks_np(n), jfk._half_masks_np(n))


@pytest.mark.parametrize("m,n", [(136, 256), (128, 512)])
def test_u8_packed_transposed_matches_b1(rng, m, n):
    """B1 packed_planes u8 ingest: even planes re, odd planes im."""
    x = rng.integers(0, 256, (4, m, n), dtype=np.uint8)
    ref = jfk.fft_rows_pallas(
        jnp.asarray(x), None, False, ordering="revorder", transposed_output=True,
        packed_planes=True, engine="roll",
    )
    t = _t(x)
    ours = tfk.fft_rows(t[0::2], t[1::2], transposed=True)
    for o, r in zip(ours, ref):
        _close(o, r)


def test_odd_channel_frame_matches_b1_with_zero_plane(rng):
    """An (h, w, 3) frame read in place through strided views equals the
    JAX path's pad + zero-plane concat + packed_planes pass."""
    h, w, hp, wp = 100, 200, 128, 256
    frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    chans = np.moveaxis(frame, -1, 0)
    pk = np.zeros((4, hp, wp), np.uint8)
    pk[:3, :h, :w] = chans
    ref = jfk.fft_rows_pallas(
        jnp.asarray(pk), None, False, ordering="revorder", transposed_output=True,
        packed_planes=True, engine="roll",
    )
    c = _t(frame).permute(2, 0, 1)
    ours = tfk.fft_rows(c[0::2], c[1::2], transposed=True, extent=(hp, wp))
    for o, r in zip(ours, ref):
        _close(o, r)


def test_real_input_live_rows_matches_b1(rng):
    """PSF first pass: real input, only the live rows nonzero."""
    psf = rng.random((20, 20)).astype(np.float32)
    pad = np.zeros((1, 128, 256), np.float32)
    pad[0, :20, :20] = psf
    ref = jfk.fft_rows_pallas(
        jnp.asarray(pad), None, False, ordering="revorder", transposed_output=True,
        engine="roll",
    )
    ours = tfk.fft_rows(_t(psf)[None], None, transposed=True, extent=(128, 256))
    for o, r in zip(ours, ref):
        _close(o, r)


@pytest.mark.parametrize("inverse", [False, True])
def test_complex_natural_store_matches_b6(rng, inverse):
    re = rng.standard_normal((2, 64, 256)).astype(np.float32)
    im = rng.standard_normal((2, 64, 256)).astype(np.float32)
    ref = jfk.fft_rows_pallas(
        jnp.asarray(re), jnp.asarray(im), inverse, ordering="revorder", engine="roll"
    )
    ours = tfk.fft_rows(_t(re), _t(im), inverse=inverse)
    for o, r in zip(ours, ref):
        _close(o, r)


def test_packed_out_matches_b3(rng):
    re = rng.standard_normal((2, 128, 256)).astype(np.float32)
    im = rng.standard_normal((2, 128, 256)).astype(np.float32)
    out_j, mm_j = jfk.fft_rows_packed_out(
        jnp.asarray(re), jnp.asarray(im), True, ordering="revorder",
        emit_minmax=True, engine="roll",
    )
    out_t, mm_t = tfk.fft_rows_packed_out(_t(re), _t(im), inverse=True)
    _close(out_t, out_j)
    # block geometry differs (TPU rows vs GPU rows per block); the
    # per-plane reductions the pipeline takes from them agree
    per_j = np.asarray(mm_j).reshape(2, -1, 4)
    per_t = mm_t.numpy().reshape(2, -1, 4)
    for col, red in ((0, np.min), (1, np.max), (2, np.min), (3, np.max)):
        _close(red(per_t[..., col], -1), red(per_j[..., col], -1))
    assert mm_t.shape == (2 * 128 // tfk.rows_per_block(256, 128), 4)


@pytest.mark.parametrize("n", [4, 64, 1024])
def test_forward_is_bit_reversed_dft(rng, n):
    """Oracle check: DIF output = the DFT in bit-reversed order, and the
    DIT inverse takes it back (unscaled by n)."""
    x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    re, im = _t(x.real.astype(np.float32))[None], _t(x.imag.astype(np.float32))[None]
    f_re, f_im = tfk.fft_rows(re, im)
    bits = n.bit_length() - 1
    rev = [int(format(k, f"0{bits}b")[::-1], 2) for k in range(n)]
    ref = torch.fft.fft(torch.from_numpy(x), dim=-1)[..., rev]
    _close((f_re + 1j * f_im.double())[0], ref)
    b_re, b_im = tfk.fft_rows(f_re, f_im, inverse=True)
    _close(b_re[0] / n, x.real)
    _close(b_im[0] / n, x.imag)


def test_rows_per_block_fits_shared_memory():
    for n in (2, 256, 2048, 4096, 65536):
        for m in (1, 50, 2048):
            r = tfk.rows_per_block(n, m)
            assert r & (r - 1) == 0 and 1 <= r <= max(1, min(16, m))
            assert r == 1 or 8 * r * n <= tfk.ROWS_SMEM_BUDGET


def test_rejects_bad_shapes():
    with pytest.raises(ValueError):
        tfk.fft_rows(torch.zeros((2, 4, 6)))
    with pytest.raises(ValueError):
        tfk.fft_rows(torch.zeros((2, 4, 8)), torch.zeros((3, 4, 8)))
    with pytest.raises(ValueError):
        tfk.fft_rows(torch.zeros((2, 4, 8), dtype=torch.float64))
