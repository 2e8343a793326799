"""Port fused spectral middle (B2) against the JAX Pallas kernel.

JAX: wiener_spectral_rows_t(engine="roll") in interpret mode on the CPU.
Port: wiener_spectral_t, whose wrapper takes the plain version for CPU
tensors. Tolerance: max error <= 1e-5 of the output's max magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_restoration_tpu.ops.pallas.fft_kernel import fft_rows_pallas
from fft_restoration_tpu.ops.pallas.wiener_spectral import wiener_spectral_rows_t
from fft_restoration_tpu_torch.ops.kernels import fft_kernel as tfk
from fft_restoration_tpu_torch.ops.kernels.wiener_spectral import wiener_spectral_t
from fft_restoration_tpu_torch.ops.wiener import wiener_filter

REL = 1e-5


def _close(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= REL * max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("m,n,K", [(128, 256, 0.01), (256, 128, 0.1)])
def test_matches_jax_spectral_rows_t(rng, m, n, K):
    # realistic operands: a row-FFT'd image pair and a PSF spectrum made
    # by the revorder forward path, as the pipeline feeds them
    a = rng.standard_normal((2, m, n)).astype(np.float32)
    h = rng.random((m, n)).astype(np.float32) / (m * n) ** 0.5
    ar, ai = fft_rows_pallas(jnp.asarray(a), None, False, ordering="revorder", engine="roll")
    hr, hi = fft_rows_pallas(jnp.asarray(h), None, False, ordering="revorder", engine="roll")
    ref = wiener_spectral_rows_t((ar, ai), (hr, hi), K, engine="roll")
    assert ref is not None
    t = [torch.from_numpy(np.array(x)) for x in (ar, ai, hr, hi)]
    ours = wiener_spectral_t(*t, K)
    assert ours[0].shape == (2, n, m)
    for o, r in zip(ours, ref):
        _close(o, r)


def test_equals_unfused_composition(rng):
    """B2 == column DIF -> wiener_filter -> column DIT -> transpose."""
    a_re, a_im, h_re, h_im = (
        torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        for s in ((3, 64, 32), (3, 64, 32), (64, 32), (64, 32))
    )
    ours = wiener_spectral_t(a_re, a_im, h_re, h_im, 0.05)
    g = tfk.fft_rows(a_re, a_im)
    f = wiener_filter(g, (h_re, h_im), 0.05)
    r = tfk.fft_rows(f[0], f[1], inverse=True, transposed=True)
    for o, x in zip(ours, r):
        assert torch.equal(o, x)


def test_rejects_mismatched_spectrum():
    a = torch.zeros((2, 64, 32))
    with pytest.raises(ValueError):
        wiener_spectral_t(a, a, torch.zeros((32, 64)), torch.zeros((32, 64)), 0.01)
    with pytest.raises(ValueError):
        wiener_spectral_t(a, a, torch.zeros((64, 32)), torch.zeros((64, 32)).double(), 0.01)
