"""The port's Richardson-Lucy (models/richardson_lucy.py) against the JAX
package and a float64 reference.

JAX: richardson_lucy_planes(fft_backend="pallas", fft_engine="roll") in
interpret mode on the CPU; the port on the CPU (plain versions). RL's
divisions amplify any float32 rounding difference between equivalent
transforms, so RL is held to the JAX package's RL contracts, not to the
one-shot filters' 1e-5: 5e-2 plane INF against JAX (fused middle at
(3, 512, 128), unfused at (3, 256, 128)), and 2e-3 against the float64
np.fft loop at 64x64 over 8 iterations (tests/test_richardson_lucy.py).

On a zero-padded frame (200x230 in 256^2, PSF(25, 30), 10 iterations)
the port, JAX's roll engine and the float64 loop start from the same
float32 planes: with the edge taper all three agree within 5e-2 (they
read ~3e-3 apart); without it the PSF's empty top rows read only the
zero pad, so the rim's blur is exactly 0 in float64 and float32
rounding over eps in float32, and every float32 RL sits ~0.1 from the
float64 one: the port is held to at most twice JAX's distance there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_restoration_tpu.models.richardson_lucy import richardson_lucy_planes as jax_rl
from fft_restoration_tpu.oracle.psf import motion_blur_kernel_oracle
from fft_restoration_tpu_torch.models.richardson_lucy import richardson_lucy_planes

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

RL_INF = 5e-2
F64_INF = 2e-3


def _rl_ref(y, psf, iters, eps=1e-6):
    """float64 np.fft RL: corner-anchored PSF, circular convolution,
    clip to [0, 1] (the JAX test's reference)."""
    pp = np.zeros(y.shape[-2:])
    pp[: psf.shape[0], : psf.shape[1]] = psf
    H = np.fft.fft2(pp)
    out = []
    for c in y:
        x = c.astype(np.float64).copy()
        for _ in range(iters):
            conv = np.real(np.fft.ifft2(np.fft.fft2(x) * H))
            ratio = c / (conv + eps)
            x = np.maximum(x * np.real(np.fft.ifft2(np.fft.fft2(ratio) * np.conj(H))), 0.0)
        out.append(np.clip(x, 0.0, 1.0))
    return np.stack(out)


@pytest.mark.parametrize("shape", [(3, 512, 128), (3, 256, 128)])
def test_rl_matches_jax_pallas(rng, shape):
    psf = motion_blur_kernel_oracle(9, 45.0).astype(np.float32)
    y = rng.random(shape).astype(np.float32)
    ref = np.asarray(jax_rl(jnp.asarray(y), jnp.asarray(psf), 2, fft_backend="pallas",
                            fft_engine="roll"))
    ours = richardson_lucy_planes(torch.from_numpy(y), torch.from_numpy(psf), 2).numpy()
    assert ours.shape == shape and ours.dtype == np.float32
    assert np.abs(ours - ref).max() <= RL_INF


@pytest.mark.parametrize("c", [3, 1])
def test_rl_matches_f64_reference(rng, c):
    psf = motion_blur_kernel_oracle(7, 30.0)
    y = rng.random((c, 64, 64)).astype(np.float32)
    ours = richardson_lucy_planes(torch.from_numpy(y), torch.from_numpy(psf.astype(np.float32)),
                                  8).numpy()
    assert np.abs(ours - _rl_ref(y, psf, 8)).max() < F64_INF


def _padded_frame(seed, h, w, length):
    """A motion-blurred uint8 frame (smooth random scene + detail) and its
    (3, hp, wp) float32 planes x / 255, zero padded to powers of two."""
    from fft_restoration_tpu_torch.host.blurgen import blur_image
    from fft_restoration_tpu_torch.host.padding import next_power_of_two

    g = np.random.default_rng(seed)
    scene = np.kron(g.integers(0, 256, (h // 16 + 2, w // 16 + 2, 3)), np.ones((16, 16, 1)))
    scene = np.clip(scene[:h, :w] * 0.8 + g.integers(0, 52, (h, w, 3)), 0, 255)
    img = blur_image(scene.astype(np.uint8), length, 30.0)
    y = np.zeros((3, next_power_of_two(h), next_power_of_two(w)), np.float32)
    y[:, :h, :w] = np.moveaxis(img.astype(np.float32) / np.float32(255.0), -1, 0)
    return img, y


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("edgetaper", [False, True])
def test_rl_padded_frame_matches_jax_and_f64(seed, edgetaper):
    from fft_restoration_tpu_torch import WienerDeblurPipeline
    from fft_restoration_tpu_torch.models.edgetaper import edge_taper_planes
    from fft_restoration_tpu_torch.ops.psf import make_psf

    h, w, length, iters = 230, 200, 25, 10
    img, y = _padded_frame(seed, h, w, length)
    psf = make_psf("motion", length, 30.0, "cpu")
    if edgetaper:
        y = edge_taper_planes(torch.from_numpy(y), psf, (h, w)).numpy()
    ours = richardson_lucy_planes(torch.from_numpy(y), psf, iters).numpy()[:, :h, :w]
    # the pipeline builds the same planes (x / 255, the same taper) and RL
    pipe = WienerDeblurPipeline("cpu", filter_name="rl", rl_iters=iters, edgetaper=edgetaper)
    assert np.array_equal(pipe.restore_channels(img, length, 30.0), ours)
    ref = _rl_ref(y, psf.numpy(), iters)[:, :h, :w]
    jax = np.asarray(jax_rl(jnp.asarray(y), jnp.asarray(psf.numpy()), iters, fft_backend="pallas",
                            fft_engine="roll"))[:, :h, :w]
    d, d_jax = np.abs(ours - ref).max(), np.abs(jax - ref).max()
    if edgetaper:
        assert d <= RL_INF and np.abs(ours - jax).max() <= RL_INF, (d, d_jax)
    else:
        assert d <= 2.0 * d_jax, (d, d_jax)


def test_rl_uint8_input_is_exact_division(rng):
    psf = torch.from_numpy(motion_blur_kernel_oracle(5, 0.0).astype(np.float32))
    y = rng.integers(0, 256, (3, 32, 32), dtype=np.uint8)
    a = richardson_lucy_planes(torch.from_numpy(y), psf, 3)
    b = richardson_lucy_planes(torch.from_numpy(y.astype(np.float32) / np.float32(255.0)), psf, 3)
    assert torch.equal(a, b)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0


def test_rl_reuses_a_given_spectrum(rng):
    from fft_restoration_tpu_torch.models.pipeline import psf_spectrum_planes

    psf = torch.from_numpy(motion_blur_kernel_oracle(7, 60.0).astype(np.float32))
    y = torch.from_numpy(rng.random((3, 64, 128)).astype(np.float32))
    H = psf_spectrum_planes(psf, 64, 128)
    assert torch.equal(richardson_lucy_planes(y, psf, 2),
                       richardson_lucy_planes(y, psf, 2, psf_spectrum=H))
    # one (Hp, Wp) plane, as JAX takes it, restores as a 1-plane stack
    assert torch.equal(richardson_lucy_planes(y[0], psf, 2),
                       richardson_lucy_planes(y[:1], psf, 2)[0])
