"""Port forward-pass + Wiener kernel (B7) and the middle gate against JAX.

JAX: fwd_wiener_rows_pallas(engine="roll") in interpret mode on the CPU.
Port: fwd_wiener_rows, whose wrapper takes the plain version for CPU
tensors. Tolerance: max error <= 1e-5 of the output's max magnitude
(float32 sums in another order).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_restoration_tpu.ops.pallas.fft_kernel import fft_rows_pallas
from fft_restoration_tpu.ops.pallas.wiener_spectral import fwd_wiener_rows_pallas
from fft_restoration_tpu_torch.models import pipeline as tpl
from fft_restoration_tpu_torch.ops.kernels import fft_kernel as tfk
from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as tws

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

REL = 1e-5


def _operands(rng, p, m, n):
    """A row-FFT'd image stack and a PSF spectrum made by the revorder
    forward path, as the pipeline feeds them (numpy, JAX roll order)."""
    a = rng.standard_normal((p, m, n)).astype(np.float32)
    h = rng.random((m, n)).astype(np.float32) / (m * n) ** 0.5
    ar, ai = fft_rows_pallas(jnp.asarray(a), None, False, ordering="revorder", engine="roll")
    hr, hi = fft_rows_pallas(jnp.asarray(h), None, False, ordering="revorder", engine="roll")
    return [np.array(x) for x in (ar, ai, hr, hi)]


@pytest.mark.parametrize("p,m,n,K", [(3, 64, 256, 0.01), (2, 128, 64, 0.1)])
def test_matches_jax_fwd_wiener_rows(rng, p, m, n, K):
    ar, ai, hr, hi = _operands(rng, p, m, n)
    ref = fwd_wiener_rows_pallas((jnp.asarray(ar), jnp.asarray(ai)), (hr, hi), K, engine="roll")
    t = [torch.from_numpy(x) for x in (ar, ai, hr, hi)]
    for fn in (tws.fwd_wiener_rows_plain, tws.fwd_wiener_rows):
        ours = fn(*t, K)
        for o, r in zip(ours, ref):
            o, r = o.numpy(), np.asarray(r)
            assert o.shape == r.shape == (p, m, n)
            assert np.abs(o - r).max() <= REL * np.abs(r).max()


def test_b7_then_inverse_t_equals_b2(rng):
    """The two middles compute one function: B7 + the inverse row pass
    with transposed store is B2, bitwise, on the plain versions."""
    a_re, a_im, h_re, h_im = (
        torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        for s in ((3, 64, 128), (3, 64, 128), (64, 128), (64, 128))
    )
    f = tws.fwd_wiener_rows(a_re, a_im, h_re, h_im, 0.02)
    pair = tfk.fft_rows(*f, inverse=True, transposed=True)
    fused = tws.wiener_spectral_t(a_re, a_im, h_re, h_im, 0.02)
    for x, y in zip(pair, fused):
        assert x.shape == (3, 128, 64)
        assert torch.equal(x, y)


@pytest.mark.parametrize("hp,fused", [(256, False), (512, True), (1024, True), (64, False)])
def test_middle_gate_follows_jax(hp, fused):
    """hp >= 512 takes B2, below it B7 + inverse-T (JAX
    _spectral_megakernel_profitable)."""
    calls = []

    def rec(name):
        return lambda *a, **k: calls.append(name) or (None, None)

    ops = SimpleNamespace(
        wiener_spectral_t=rec("B2"), fwd_wiener_rows=rec("B7"), fft_rows=rec("inverse_T"),
    )
    a = torch.zeros((1, 8, hp))
    tpl.spectral_middle(a, a, (None, None), 0.01, ops)
    assert calls == (["B2"] if fused else ["B7", "inverse_T"])


def test_rejects_mismatched_spectrum():
    a = torch.zeros((2, 64, 32))
    with pytest.raises(ValueError):
        tws.fwd_wiener_rows(a, a, torch.zeros((32, 64)), torch.zeros((32, 64)), 0.01)
    with pytest.raises(ValueError):
        tws.fwd_wiener_rows(a, a[:, :, :16], torch.zeros((64, 32)), torch.zeros((64, 32)), 0.01)
