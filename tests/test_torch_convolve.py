"""The port's circular convolution (models/convolve.py) against the JAX
package's pallas path.

JAX: circular_conv_builder(fft_backend="pallas", fft_engine="roll") in
interpret mode on the CPU. Port: circular_conv_builder on the CPU, where
every kernel wrapper takes its plain version. (3, 512, 128) takes the
fused B2 'conv' middle on both sides, (3, 256, 128) the unfused one
(column pass, complex multiply, inverse column pass). Both return
natural-order spatial planes, scaled by 1/(hp*wp). Tolerance: max error
<= 1e-5 of the output's max magnitude.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_restoration_tpu.models.convolve import circular_conv_builder as jax_conv_builder
from fft_restoration_tpu.models.pipeline import _pack_channel_pairs, _unpack_channel_pairs
from fft_restoration_tpu.oracle.psf import motion_blur_kernel_oracle
from fft_restoration_tpu_torch.models import convolve

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

REL = 1e-5


def _close(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= REL * max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("shape", [(3, 512, 128), (3, 256, 128)])
def test_conv_matches_jax_pallas(rng, shape):
    _, hp, wp = shape
    psf = motion_blur_kernel_oracle(9, 45.0).astype(np.float32)
    y = rng.random(shape).astype(np.float32)
    jconv = jax_conv_builder(jnp.asarray(psf), hp, wp, fft_backend="pallas", fft_engine="roll")
    re, im = _pack_channel_pairs(jnp.asarray(y))
    tconv = convolve.circular_conv_builder(torch.from_numpy(psf), hp, wp)
    t = torch.from_numpy(y)
    for conj in (False, True):
        ref = jconv(re, im, conj)
        ours = tconv(t[0::2], t[1::2], conj)
        for o, r in zip(ours, ref):
            _close(o, r)


def test_conv_is_circular_convolution(rng):
    """Against np.fft in float64: the blur model, and conj=True the
    convolution with the mirrored PSF."""
    psf = motion_blur_kernel_oracle(7, 30.0)
    y = rng.random((2, 64, 32))
    conv = convolve.circular_conv_builder(torch.from_numpy(psf.astype(np.float32)), 64, 32)
    pp = np.zeros((64, 32))
    pp[: psf.shape[0], : psf.shape[1]] = psf
    H = np.fft.fft2(pp)
    for conj in (False, True):
        ref = np.real(np.fft.ifft2(np.fft.fft2(y) * (np.conj(H) if conj else H)))
        ours = conv(torch.from_numpy(y[:1].astype(np.float32)),
                    torch.from_numpy(y[1:].astype(np.float32)), conj)
        assert np.abs(ours[0].numpy()[0] - ref[0]).max() <= 1e-5
        assert np.abs(ours[1].numpy()[0] - ref[1]).max() <= 1e-5


@pytest.mark.parametrize("hp,fused", [(512, True), (1024, True), (256, False), (64, False)])
def test_middle_gate_follows_jax(hp, fused):
    """hp >= 512 takes B2 'conv', below it the column pass, the multiply
    in torch and the inverse column pass (JAX _spectral_megakernel_profitable)."""
    calls = []

    def rec(name, always_t=False):
        def op(re, im, *a, **k):  # shapes as the real ops give them
            calls.append(name)
            t = always_t or k.get("transposed", False)
            return (re.transpose(1, 2), im.transpose(1, 2)) if t else (re, im)
        return op

    ops = SimpleNamespace(spectral_conv_t=rec("B2_conv", True), fft_rows=rec("fft_rows"))
    h = torch.zeros((8, hp))
    conv = convolve.circular_conv_builder(None, hp, 8, psf_spectrum=(h, h), ops=ops)
    a = torch.zeros((1, hp, 8))
    conv(a, a)
    if fused:
        assert calls == ["fft_rows", "B2_conv", "fft_rows"]
    else:
        assert calls == ["fft_rows"] * 4


@pytest.mark.parametrize("c", [1, 2, 3, 6])
def test_pair_packing_matches_jax(rng, c):
    x = rng.random((c, 4, 8)).astype(np.float32)
    jre, jim = _pack_channel_pairs(jnp.asarray(x))
    re, im = convolve.pack_pairs(torch.from_numpy(x))
    np.testing.assert_array_equal(re.numpy(), np.asarray(jre))
    np.testing.assert_array_equal(im.numpy(), np.asarray(jim))
    back = convolve.unpack_pairs(re, im, c)
    np.testing.assert_array_equal(back.numpy(), np.asarray(_unpack_channel_pairs(jre, jim, c)))
    np.testing.assert_array_equal(back.numpy(), x)
