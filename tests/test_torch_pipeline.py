"""The port's restore slice against the JAX package and the serial oracle.

JAX: WienerDeblurPipeline(fft_backend="pallas") on the CPU (Pallas in
interpret mode, default mxu engine). The port runs on the CPU, where
every kernel wrapper takes its plain version. Spectra differ in order
between the engines (the port is pure radix-2, bit-reversed), so the
comparison is after the inverse: restored planes <= 1e-5 max abs,
uint8 <= 1 count, and both pass the oracle's inf tier.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fft_restoration_tpu.models.pipeline import WienerDeblurPipeline as JaxPipeline
from fft_restoration_tpu.models.pipeline import psf_spectrum_planes
from fft_restoration_tpu.ops.psf import make_psf as jax_make_psf
from fft_restoration_tpu.oracle.psf import make_psf_oracle
from fft_restoration_tpu.oracle.serial import restore_channels
from fft_restoration_tpu.utils.blurgen import blur_image
from fft_restoration_tpu.utils.verify import channels_equal
from fft_restoration_tpu_torch.models import pipeline as tpl
from fft_restoration_tpu_torch.ops.psf import make_psf, motion_blur_kernel

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

L, ANGLE, K = 15, 30.0, 0.01


def _frame(h, w, seed):
    rng = np.random.default_rng(seed)
    return blur_image(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), L, ANGLE)


def _oracle(img):
    imgf = np.moveaxis(img.astype(np.float32) / np.float32(255.0), -1, 0)
    return restore_channels(imgf, make_psf_oracle("motion", L, ANGLE), K)


def _u8_diff(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


@pytest.mark.parametrize(
    "h,w,stride", [(256, 256, 1), (200, 230, 1), (300, 520, 1), (300, 520, 4)]
)
def test_slice_matches_jax_pallas_pipeline(h, w, stride):
    img = _frame(h, w, seed=h + w)
    out_j, planes_j = JaxPipeline(
        fft_backend="pallas", wb_stats_stride=stride
    ).restore_with_planes(img, L, ANGLE, K)
    out_t, planes_t = tpl.WienerDeblurPipeline(
        "cpu", wb_stats_stride=stride
    ).restore_with_planes(img, L, ANGLE, K)
    assert out_t.shape == (h, w, 3) and out_t.dtype == np.uint8
    assert planes_t.shape == (3, h, w) and planes_t.dtype == np.float32
    assert np.abs(planes_t - planes_j).max() <= 1e-5
    assert _u8_diff(out_t, out_j) <= 1
    oracle = _oracle(img)
    assert channels_equal(planes_t, oracle, "inf").passed
    assert channels_equal(planes_j, oracle, "inf").passed


def test_no_white_balance_and_serving_graph_match_jax():
    img = _frame(128, 200, seed=5)
    out_j = JaxPipeline(fft_backend="pallas", white_balance=False).restore(img, L, ANGLE, K)
    out_t = tpl.WienerDeblurPipeline("cpu", white_balance=False).restore(img, L, ANGLE, K)
    assert _u8_diff(out_t, out_j) <= 1
    serve = tpl.WienerDeblurPipeline("cpu", emit_planes=False)
    full = tpl.WienerDeblurPipeline("cpu")
    assert np.array_equal(serve.restore(img, L, ANGLE, K), full.restore(img, L, ANGLE, K))
    with pytest.raises(ValueError):
        serve.restore_with_planes(img, L, ANGLE, K)


def test_psf_spectrum_matches_jax_roll_and_carries_over():
    """JAX psf_spectrum_planes(engine='roll') is the port's layout: equal
    to rel 1e-5, and loaded into the port's cache it restores a frame
    like the port's own spectrum."""
    h, w = 200, 230
    hp, wp, _, _ = tpl.pad_extents(h, w)
    hj = psf_spectrum_planes(jax_make_psf("motion", L, ANGLE), hp, wp, engine="roll", psf_rows=L)
    ht = tpl.psf_spectrum_planes(make_psf("motion", L, ANGLE, "cpu"), hp, wp)
    for o, r in zip(ht, hj):
        r = np.asarray(r)
        assert o.shape == r.shape == (wp, hp)
        assert np.abs(o.numpy() - r).max() <= 1e-5 * np.abs(r).max()

    img = _frame(h, w, seed=9)
    own = tpl.WienerDeblurPipeline("cpu")
    carried = tpl.WienerDeblurPipeline("cpu")
    carried.load_psf_spectrum(h, w, L, ANGLE, (np.asarray(hj[0]), np.asarray(hj[1])))
    out_o, planes_o = own.restore_with_planes(img, L, ANGLE, K)
    out_c, planes_c = carried.restore_with_planes(img, L, ANGLE, K)
    assert np.abs(planes_c - planes_o).max() <= 1e-5
    assert _u8_diff(out_c, out_o) <= 1
    with pytest.raises(ValueError):
        carried.load_psf_spectrum(h, w, L, ANGLE, (np.zeros((wp, 2 * hp)), np.zeros((wp, 2 * hp))))


def test_psf_cache_is_bounded():
    pipe = tpl.WienerDeblurPipeline("cpu")
    for k in range(tpl.PSF_CACHE_SIZE + 3):
        pipe._psf_spectrum(64, 64, 5, float(k))
    assert len(pipe._psf_cache) == tpl.PSF_CACHE_SIZE
    assert (64, 64, (), (), 5, 0.0) not in pipe._psf_cache  # oldest evicted first
    assert (64, 64, (), (), 5, float(tpl.PSF_CACHE_SIZE + 2)) in pipe._psf_cache


@pytest.mark.parametrize("size,angle", [(1, 0.0), (9, 30.0), (15, 45.0), (50, 30.0), (40, 117.5)])
def test_motion_blur_kernel_matches_oracle(size, angle):
    ours = motion_blur_kernel(size, angle, "cpu").numpy()
    ref = make_psf_oracle("motion", size, angle)
    assert ours.dtype == np.float32
    assert np.abs(ours - ref).max() <= 1e-6


@pytest.mark.parametrize("kind,param", [("gaussian", 2.5), ("disk", 0.0)])
def test_psf_family_matches_jax(kind, param):
    ours = make_psf(kind, 9, param, "cpu").numpy()
    assert np.abs(ours - np.asarray(jax_make_psf(kind, 9, jnp.float32(param)))).max() <= 1e-6


def test_slices_not_ported_raise():
    with pytest.raises(ValueError, match="unknown filter"):
        tpl.WienerDeblurPipeline("cpu", filter_name="wienerr")
    with pytest.raises(ValueError, match="unknown pad mode"):
        tpl.WienerDeblurPipeline("cpu", pad_mode="pow3")
    with pytest.raises(ValueError):
        tpl.WienerDeblurPipeline("cpu").restore(_frame(64, 64, 1), 100, 0.0)
    # the smooth pad is ported: a 64x300 frame restores at 64x384, (3,) on W
    smooth = tpl.WienerDeblurPipeline("cpu", pad_mode="smooth")
    assert smooth.pad(64, 300) == (64, 384, (), (3,))
    out, planes = smooth.restore_with_planes(_frame(64, 300, 2), L, ANGLE, K)
    assert out.shape == (64, 300, 3) and out.dtype == np.uint8
    assert planes.shape == (3, 64, 300) and np.isfinite(planes).all()


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error path cannot run")
    with pytest.raises(RuntimeError, match="cuda"):
        tpl.WienerDeblurPipeline("cuda")


def test_port_imports_no_jax(tmp_path):
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import fft_restoration_tpu_torch, fft_restoration_tpu_torch.cli\n"
        "import fft_restoration_tpu_torch.models.pipeline\n"
        "import fft_restoration_tpu_torch.models.batched\n"
        "import fft_restoration_tpu_torch.tools.profile_paths\n"
        "import fft_restoration_tpu_torch.tools.bench\n"
        "import fft_restoration_tpu_torch.utils.timing, fft_restoration_tpu_torch.utils.trace_profile\n"
        "from fft_restoration_tpu_torch import BatchedWienerPipeline, psf_grid_sweep\n"
        "import fft_restoration_tpu_torch.ops.kernels._build\n"
        "import fft_restoration_tpu_torch.ops.kernels.postprocess\n"
        "import fft_restoration_tpu_torch.ops.kernels.wiener_spectral\n"
        "import fft_restoration_tpu_torch.host.blurgen, fft_restoration_tpu_torch.host.imageio\n"
        "import fft_restoration_tpu_torch.host.oracle, fft_restoration_tpu_torch.host.verify\n"
        "from fft_restoration_tpu_torch import WienerDeblurPipeline\n"
        "from fft_restoration_tpu_torch.host.imageio import imwrite\n"
        # the CLI's directory path end to end: two frames, one size
        f"d = {str(tmp_path)!r}\n"
        "for n in ('a', 'b'):\n"
        "    imwrite(f'{d}/{n}.png', np.full((16, 16, 3), 90, np.uint8))\n"
        "assert fft_restoration_tpu_torch.cli.main([d, '3', '0', '--device', 'cpu']) == 0\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'triton', 'fft_restoration_tpu')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
