"""Each hand-written kernel against its plain version, on an NVIDIA GPU.

Skips where there is no card. On a machine with one (which need not have
JAX) run:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerances: FFT family and spectral middles (Wiener and conv) 1e-5 of
the output's max magnitude (float32, FMA contraction, same tables);
Lab-L partials rel 1e-4 (hardware ex2/lg2 and summation order); uint8
<= 1 count (the white-balance kernels, csrc/postprocess.cu, launch
twice bitwise equal); Richardson-Lucy's kernel path against its plain path 1e-4
planes and 1 count on frames that fill their pow2 extent; RL on
zero-padded frames against the float64 RL of the same input planes:
5e-2 plane INF with the edge taper (the JAX package's RL contract), and
without it at most twice an independent float32 RL's (torch.fft)
distance, since there every float32 RL sits ~0.1 from the float64 one.
Mixed radix (--pad smooth): the same 1e-5 for every kernel with cross
levels, 1e-4 planes and 1 count for the smooth restore paths. The ops
layer (B6 natural, B9 wiener_elem, B10 wiener_spectral_rows, B11
fft_cols, B12 radix-4): 1e-5 of the output's max magnitude against the
plain version; the generic route on the card against its CPU run 1e-5
planes, 1 count.
"""

import numpy as np
import pytest
import torch

pytestmark = [
    pytest.mark.requires_cuda,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs an NVIDIA GPU"),
]


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.fixture
def dev():
    return torch.device("cuda", 0)


@pytest.fixture
def gen():
    return np.random.default_rng(7)


@pytest.mark.parametrize("h,w", [(330, 640), (782, 1920), (64, 2), (1, 4096)])
@pytest.mark.parametrize("transposed", [True, False])
def test_fft_rows_u8_frame(dev, gen, h, w, transposed):
    from fft_restoration_tpu_torch.host.padding import next_power_of_two
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk

    frame = torch.as_tensor(gen.integers(0, 256, (h, w, 3), dtype=np.uint8), device=dev)
    c = frame.permute(2, 0, 1)
    ext = (next_power_of_two(h), next_power_of_two(w))
    ours = fk.fft_rows(c[0::2], c[1::2], transposed=transposed, extent=ext)
    ref = fk.fft_rows_plain(c[0::2], c[1::2], transposed=transposed, extent=ext)
    for o, r in zip(ours, ref):
        assert _rel(o, r) <= 1e-5


@pytest.mark.parametrize("m,n", [(256, 2048), (2048, 256), (8, 4096)])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_rows_complex_and_packed(dev, gen, m, n, inverse):
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk

    re, im = (torch.as_tensor(gen.standard_normal((2, m, n), dtype=np.float32), device=dev)
              for _ in range(2))
    for o, r in zip(fk.fft_rows(re, im, inverse=inverse),
                    fk.fft_rows_plain(re, im, inverse=inverse)):
        assert _rel(o, r) <= 1e-5
    out, mm = fk.fft_rows_packed_out(re, im, inverse=inverse)
    out_p, mm_p = fk.fft_rows_packed_out_plain(re, im, inverse=inverse)
    assert _rel(out, out_p) <= 1e-5 and _rel(mm, mm_p) <= 1e-5


@pytest.mark.parametrize("m,n", [(2048, 2048), (1024, 2048), (512, 128), (37, 2048), (6, 4096)])
def test_wiener_spectral_t(dev, gen, m, n):
    from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as ws

    a_re, a_im = (torch.as_tensor(gen.standard_normal((2, m, n), dtype=np.float32), device=dev)
                  for _ in range(2))
    h_re, h_im = (torch.as_tensor(gen.standard_normal((m, n), dtype=np.float32), device=dev)
                  for _ in range(2))
    ours = ws.wiener_spectral_t(a_re, a_im, h_re, h_im, 0.01)
    ref = ws.wiener_spectral_t_plain(a_re, a_im, h_re, h_im, 0.01)
    for o, r in zip(ours, ref):
        assert _rel(o, r) <= 1e-5


@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("m,n", [(2048, 2048), (1024, 2048), (512, 128), (8, 4), (37, 2048),
                                 (6, 16384)])
def test_spectral_conv_t(dev, gen, m, n, conj):
    from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as ws

    a_re, a_im = (torch.as_tensor(gen.standard_normal((2, m, n), dtype=np.float32), device=dev)
                  for _ in range(2))
    h_re, h_im = (torch.as_tensor(gen.standard_normal((m, n), dtype=np.float32), device=dev)
                  for _ in range(2))
    ours = ws.spectral_conv_t(a_re, a_im, h_re, h_im, conj)
    ref = ws.spectral_conv_t_plain(a_re, a_im, h_re, h_im, conj)
    for o, r in zip(ours, ref):
        assert o.shape == (2, n, m) and _rel(o, r) <= 1e-5
    if conj:  # the JAX package's form: a negated H_im, no flag
        for o, r in zip(ours, ws.spectral_conv_t(a_re, a_im, h_re, -h_im)):
            assert _rel(o, r) <= 1e-5


# RL's frames here fill their pow2 extent, so the kernel path is held to
# its plain path as tightly as the one-shot filters are;
# test_rl_padded_frame_vs_f64 takes the zero-padded frames
@pytest.mark.parametrize("filter_name,edgetaper,h,w", [("rl", False, 512, 256),
                                                       ("rl", True, 256, 256),
                                                       ("wiener", True, 300, 520),
                                                       ("inverse", False, 300, 520),
                                                       ("cls", True, 300, 520)])
def test_filter_family_kernels_vs_plain_and_launches(dev, gen, filter_name, edgetaper, h, w):
    from fft_restoration_tpu_torch import WienerDeblurPipeline
    from fft_restoration_tpu_torch.host.blurgen import blur_image
    from fft_restoration_tpu_torch.models.pipeline import (
        PLAIN_OPS, _restore_core, laplacian_spectrum, pad_extents, psf_spectrum_planes,
    )
    from fft_restoration_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from fft_restoration_tpu_torch.ops.psf import make_psf

    # block scenes on a grey floor: RL on white noise sits at its spikes'
    # clip edges, where any rounding flips whole counts
    scene = np.full((h, w, 3), 40, np.uint8)
    scene[h // 7: h * 2 // 3, w // 5: w // 2] = 200
    scene[h * 2 // 5: h // 2 + 2, w // 9: w * 5 // 6] = gen.integers(100, 160, (3,))
    img = blur_image(scene, 21, 60.0)
    kw = dict(filter_name=filter_name, edgetaper=edgetaper, rl_iters=3)
    reset_launch_counts()
    out, planes = WienerDeblurPipeline("cuda", **kw).restore_with_planes(img, 21, 60.0, 0.01)
    hp, wp, _, _ = pad_extents(h, w)
    convs = (2 * 3 if filter_name == "rl" else 0) + edgetaper
    # hp >= 512: each conv's middle is B2 'conv'; below, the unfused middle
    assert launch_counts["spectral_conv_t"] == (convs if hp >= 512 else 0), dict(launch_counts)
    assert launch_counts["wiener_spectral_t"] == (filter_name == "wiener" and hp >= 512)
    H = psf_spectrum_planes(make_psf("motion", 21, 60.0, dev), hp, wp, PLAIN_OPS)
    lap = laplacian_spectrum(hp, wp, dev, PLAIN_OPS) if filter_name == "cls" else None
    out_p, planes_p = _restore_core(torch.as_tensor(img, device=dev), H, 0.01, white_balance=True,
                                    emit_planes=True, wb_stats_stride=1, ops=PLAIN_OPS,
                                    psf=make_psf("motion", 21, 60.0, dev), lap=lap, **kw)
    planes_tol = 1e-4 if filter_name == "rl" else 2e-4
    assert np.abs(planes - planes_p.cpu().numpy()).max() <= planes_tol
    assert np.abs(out.astype(np.int32) - out_p.cpu().numpy().astype(np.int32)).max() <= 1


def test_u8_to_unit_is_true_division(dev):
    from fft_restoration_tpu_torch.models.pipeline import padded_planes
    from fft_restoration_tpu_torch.ops.kernels import u8_to_unit

    v = np.arange(256, dtype=np.uint8)
    exact = torch.from_numpy(v.astype(np.float32) / np.float32(255.0))
    assert torch.equal(u8_to_unit(torch.as_tensor(v, device=dev)).cpu(), exact)
    frame = torch.as_tensor(np.resize(v, (5, 86, 3)), device=dev)[None]
    assert torch.equal(padded_planes(frame, 8, 128)[:, :5, :86].cpu(),
                       exact[frame.cpu().long()].permute(0, 3, 1, 2).reshape(3, 5, 86))


def _rl_f64(y, psf, iters, eps=1e-6):
    """float64 np.fft RL of (C, hp, wp) planes (tests/test_richardson_lucy.py)."""
    pp = np.zeros(y.shape[-2:])
    pp[: psf.shape[0], : psf.shape[1]] = psf
    H = np.fft.fft2(pp)
    x = y.astype(np.float64)
    for _ in range(iters):
        ratio = y / (np.real(np.fft.ifft2(np.fft.fft2(x) * H)) + eps)
        x = np.maximum(x * np.real(np.fft.ifft2(np.fft.fft2(ratio) * np.conj(H))), 0.0)
    return np.clip(x, 0.0, 1.0)


def _rl_f32_torch_fft(y, psf, iters, eps=1e-6):
    """The same loop in float32 through torch.fft: the independent witness."""
    pp = torch.zeros(y.shape[-2:], device=y.device)
    pp[: psf.shape[0], : psf.shape[1]] = psf
    H = torch.fft.fft2(pp)
    x = y.clone()
    for _ in range(iters):
        d = torch.fft.ifft2(torch.fft.fft2(x) * H).real
        x = torch.clamp_min(x * torch.fft.ifft2(torch.fft.fft2(y / (d + eps)) * H.conj()).real, 0)
    return torch.clamp(x, 0.0, 1.0)


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("edgetaper", [False, True])
def test_rl_padded_frame_vs_f64(dev, seed, edgetaper):
    from fft_restoration_tpu_torch import WienerDeblurPipeline
    from fft_restoration_tpu_torch.host.blurgen import blur_image
    from fft_restoration_tpu_torch.models.edgetaper import edge_taper_planes
    from fft_restoration_tpu_torch.models.pipeline import padded_planes
    from fft_restoration_tpu_torch.ops.psf import make_psf

    h, w, length = 230, 200, 25  # padded to 256^2
    rng = np.random.default_rng(seed)
    scene = np.kron(rng.integers(0, 256, (h // 16 + 2, w // 16 + 2, 3)), np.ones((16, 16, 1)))
    img = blur_image(np.clip(scene[:h, :w] * 0.8 + rng.integers(0, 52, (h, w, 3)), 0, 255
                             ).astype(np.uint8), length, 30.0)
    psf = make_psf("motion", length, 30.0, dev)
    y = padded_planes(torch.as_tensor(img, device=dev)[None], 256, 256)
    if edgetaper:
        y = edge_taper_planes(y, psf, (h, w))
    planes = WienerDeblurPipeline("cuda", filter_name="rl", edgetaper=edgetaper
                                  ).restore_channels(img, length, 30.0)
    ref = _rl_f64(y.cpu().numpy(), psf.cpu().numpy(), 10)[:, :h, :w]
    d = np.abs(planes - ref).max()
    if edgetaper:
        assert d <= 5e-2
    else:
        witness = _rl_f32_torch_fft(y, psf, 10).cpu().numpy()[:, :h, :w]
        assert d <= 2.0 * np.abs(witness - ref).max()


# the original frame as the pipelines pass it (the permuted view of the
# (h, w, 3) stack, read as 32-bit words), as contiguous uint8 planes, as
# float32, and as a window of a wider stack (words on some rows only)
ORIG_FORMS = ("stack", "planes", "float32", "window")


def _orig(frame, form):
    h, w, _ = frame.shape
    if form == "planes":
        return frame.permute(2, 0, 1).contiguous()
    if form == "float32":
        return frame.permute(2, 0, 1).float() / 255.0
    if form == "window":
        big = torch.zeros((h, w + 5, 3), dtype=torch.uint8, device=frame.device)
        big[:, 4:w + 4] = frame
        return big[:, 4:w + 4].permute(2, 0, 1)
    return frame.permute(2, 0, 1)


@pytest.mark.parametrize("ext,live,stride,block", [
    ((1024, 2048), (782, 1920), 1, 64), ((1024, 2048), (782, 1920), 4, 8),
    ((2048, 2048), (2048, 2048), 4, 8), ((128, 256), (100, 130), 1, 64),
    ((256, 256), (150, 202), 1, 64), ((1024, 2048), (782, 1918), 1, 64),
    ((1024, 2048), (782, 1917), 4, 8), ((2304, 3840), (2160, 3840), 1, 64),
    ((2304, 3840), (2160, 3840), 4, 8), ((8, 2), (5, 1), 1, 64)])
@pytest.mark.parametrize("form", ORIG_FORMS)
def test_postprocess_kernels(dev, gen, ext, live, stride, block, form):
    """csrc/postprocess.cu against the plain versions: live widths with w %
    4 != 0, the UHD frame's smooth extents, a plane narrower than a float4,
    each form of the original frame; two launches bitwise equal."""
    from fft_restoration_tpu_torch.ops.kernels import postprocess as pp

    h, w = live
    raw = torch.as_tensor(gen.standard_normal((4, *ext), dtype=np.float32), device=dev)
    lo = raw[:3].amin((1, 2))
    scale = 1.0 / (raw[:3].amax((1, 2)) - lo)
    frame = torch.as_tensor(gen.integers(0, 256, (h, w, 3), dtype=np.uint8), device=dev)
    orig = _orig(frame, form)
    parts = pp.lab_l_sum_partials(raw, orig, lo, scale, live, stride, block)
    parts_p = pp.lab_l_sum_partials_plain(raw, orig, lo, scale, live, stride, block)
    assert parts.shape == parts_p.shape and _rel(parts, parts_p) <= 1e-4
    assert torch.equal(pp.lab_l_sum_partials(raw, orig, lo, scale, live, stride, block), parts)
    if form != "stack":
        return
    gain = torch.tensor([1.1], device=dev)
    enc = pp.wb_encode_u8(raw, gain, lo, scale, live)
    enc_p = pp.wb_encode_u8_plain(raw, gain, lo, scale, live)
    assert enc.shape == (h, w, 3)
    assert int((enc.int() - enc_p.int()).abs().max()) <= 1
    assert torch.equal(pp.wb_encode_u8(raw, gain, lo, scale, live), enc)


def test_pipeline_kernels_vs_plain_and_launches(dev, gen):
    from fft_restoration_tpu_torch import WienerDeblurPipeline
    from fft_restoration_tpu_torch.host.blurgen import blur_image
    from fft_restoration_tpu_torch.models.pipeline import (
        PLAIN_OPS, _restore_core, pad_extents, psf_spectrum_planes,
    )
    from fft_restoration_tpu_torch.ops.kernels import KERNELS, launch_counts, reset_launch_counts
    from fft_restoration_tpu_torch.ops.psf import make_psf

    img = blur_image(gen.integers(0, 256, (300, 520, 3), dtype=np.uint8), 21, 60.0)
    reset_launch_counts()
    out, planes = WienerDeblurPipeline("cuda").restore_with_planes(img, 21, 60.0, 0.01)
    # hp = 512 takes the fused middle (B2), not B7
    wiener = ("fft_rows", "fft_rows_t", "wiener_spectral_t", "lab_l_sum_partials", "wb_encode_u8")
    assert all(launch_counts[k] > 0 for k in wiener), dict(launch_counts)
    # every transposed pass (the frame's, the PSF's) runs B1's kernel
    assert launch_counts["fft_rows_t"] == 2, dict(launch_counts)
    assert not any(launch_counts[k] for k in KERNELS if k not in wiener), dict(launch_counts)
    assert launch_counts["fwd_wiener_rows"] == 0 and launch_counts["spectral_conv_t"] == 0
    assert launch_counts["mixed_radix"] == 0  # pow2 extents take the pow2 instances
    H = psf_spectrum_planes(make_psf("motion", 21, 60.0, dev), *pad_extents(300, 520)[:2],
                            PLAIN_OPS)
    out_p, planes_p = _restore_core(torch.as_tensor(img, device=dev), H, 0.01, white_balance=True,
                                    emit_planes=True, wb_stats_stride=1, ops=PLAIN_OPS)
    assert np.abs(planes - planes_p.cpu().numpy()).max() <= 1e-4
    assert np.abs(out.astype(np.int32) - out_p.cpu().numpy().astype(np.int32)).max() <= 1


@pytest.mark.parametrize("b,h,w", [(64, 256, 256), (3, 150, 200), (1, 330, 640), (2, 2048, 2048)])
def test_fft_rows_stack_loader(dev, gen, b, h, w):
    from fft_restoration_tpu_torch.host.padding import next_power_of_two
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk

    stack = torch.as_tensor(gen.integers(0, 256, (b, h, w, 3), dtype=np.uint8), device=dev)
    ext = (next_power_of_two(h), next_power_of_two(w))
    ours = fk.fft_rows_stack(stack, extent=ext)
    ref = fk.fft_rows_stack_plain(stack, extent=ext)
    for o, r in zip(ours, ref):
        assert o.shape == r.shape == (-(-3 * b // 2), ext[1], ext[0])
        assert _rel(o, r) <= 1e-5
    if b == 1:  # the single-frame views launch the same loads: bitwise
        c = stack[0].permute(2, 0, 1)
        for o, r in zip(ours, fk.fft_rows(c[0::2], c[1::2], transposed=True, extent=ext)):
            assert torch.equal(o, r)


@pytest.mark.parametrize("p,m,n", [(96, 256, 256), (2, 2048, 2048), (3, 128, 64), (5, 37, 256),
                                   (2, 6, 2048)])
def test_fwd_wiener_rows_and_inverse_t(dev, gen, p, m, n):
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk
    from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as ws

    a_re, a_im = (torch.as_tensor(gen.standard_normal((p, m, n), dtype=np.float32), device=dev)
                  for _ in range(2))
    h_re, h_im = (torch.as_tensor(gen.standard_normal((m, n), dtype=np.float32), device=dev)
                  for _ in range(2))
    f = ws.fwd_wiener_rows(a_re, a_im, h_re, h_im, 0.01)
    f_p = ws.fwd_wiener_rows_plain(a_re, a_im, h_re, h_im, 0.01)
    for o, r in zip(f, f_p):
        assert _rel(o, r) <= 1e-5
    inv = fk.fft_rows(*f_p, inverse=True, transposed=True)
    inv_p = fk.fft_rows_plain(*f_p, inverse=True, transposed=True)
    for o, r in zip(inv, inv_p):
        assert o.shape == (p, n, m) and _rel(o, r) <= 1e-5


@pytest.mark.parametrize("b,live,stride,block", [(64, (256, 256), 1, 64), (64, (256, 256), 4, 8),
                                                 (3, (150, 200), 1, 64), (8, (2048, 2048), 4, 8),
                                                 (5, (150, 202), 1, 64), (16, (2048, 2048), 1, 64)])
def test_batched_postprocess_kernels(dev, gen, b, live, stride, block):
    from fft_restoration_tpu_torch.host.padding import next_power_of_two
    from fft_restoration_tpu_torch.ops.kernels import postprocess as pp

    h, w = live
    n = 3 * b + (3 * b) % 2  # a packed odd stack's phantom plane
    g = torch.Generator(device=dev).manual_seed(int(gen.integers(1 << 30)))
    raw = torch.randn((n, next_power_of_two(h), next_power_of_two(w)), generator=g, device=dev)
    lo = raw[: 3 * b].amin((1, 2))
    scale = 1.0 / (raw[: 3 * b].amax((1, 2)) - lo)
    orig = torch.as_tensor(gen.integers(0, 256, (b, h, w, 3), dtype=np.uint8),
                           device=dev).permute(0, 3, 1, 2)
    parts = pp.lab_l_sum_partials_batched(raw, orig, lo, scale, live, stride, block)
    parts_p = pp.lab_l_sum_partials_batched_plain(raw, orig, lo, scale, live, stride, block)
    assert parts.shape == parts_p.shape and _rel(parts, parts_p) <= 1e-4
    assert torch.equal(pp.lab_l_sum_partials_batched(raw, orig, lo, scale, live, stride, block),
                       parts)
    gains = torch.linspace(0.9, 1.2, b, device=dev)
    enc = pp.wb_encode_u8_batched(raw, gains, lo, scale, live)
    enc_p = pp.wb_encode_u8_batched_plain(raw, gains, lo, scale, live)
    assert enc.shape == (b, h, w, 3)
    assert int((enc.int() - enc_p.int()).abs().max()) <= 1
    assert torch.equal(pp.wb_encode_u8_batched(raw, gains, lo, scale, live), enc)


@pytest.mark.parametrize("rows_a_thread", [1, 2, 4, 8])
def test_postprocess_geometries_past_65535_blocks(dev, gen, rows_a_thread):
    """Every rows-a-thread geometry of the plans at B = 16 at 2048^2, where
    one row a thread launches 65536 blocks."""
    from fft_restoration_tpu_torch.ops.kernels import postprocess as pp

    b, h, w = 16, 2048, 2048
    g = torch.Generator(device=dev).manual_seed(int(gen.integers(1 << 30)))
    raw = torch.randn((3 * b, h, w), generator=g, device=dev)
    lo = raw.amin((1, 2))
    scale = 1.0 / (raw.amax((1, 2)) - lo)
    orig = torch.randint(0, 256, (b, h, w, 3), generator=g, device=dev,
                         dtype=torch.uint8).permute(0, 3, 1, 2)
    lab = pp.lab_l_plan(b, h, w, (h, w), 1, 64, rows_a_thread)
    enc = pp.wb_encode_plan(b, (h, w), rows_a_thread)
    if rows_a_thread == 1:
        assert lab.n_ctas > 65535 and enc.n_ctas > 65535
    parts = pp._launch_lab(raw, orig, lo, scale, lab).sum(dim=2)
    parts_p = pp.lab_l_sum_partials_batched_plain(raw, orig, lo, scale, (h, w))
    assert _rel(parts, parts_p) <= 1e-4
    gains = torch.linspace(0.9, 1.2, b, device=dev)
    out = pp._launch_encode(raw, gains, lo, scale, enc)
    out_p = pp.wb_encode_u8_batched_plain(raw, gains, lo, scale, (h, w))
    assert int((out.int() - out_p.int()).abs().max()) <= 1


@pytest.mark.parametrize("b,h,w,psf,stride", [(64, 256, 256, 25, 1), (3, 150, 200, 15, 1),
                                              (2, 300, 128, 15, 4)])
def test_batched_pipeline_kernels_vs_plain_and_launches(dev, gen, b, h, w, psf, stride):
    from fft_restoration_tpu_torch import BatchedWienerPipeline
    from fft_restoration_tpu_torch.host.blurgen import blur_image
    from fft_restoration_tpu_torch.models.pipeline import (
        PLAIN_OPS, pad_extents, psf_spectrum_planes, restore_stack,
    )
    from fft_restoration_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from fft_restoration_tpu_torch.ops.psf import make_psf

    stack = np.stack([blur_image(gen.integers(0, 256, (h, w, 3), dtype=np.uint8), psf, 30.0)
                      for _ in range(b)])
    pipe = BatchedWienerPipeline("cuda", wb_stats_stride=stride)
    reset_launch_counts()
    out, planes = (t.cpu().numpy() for t in pipe.run(pipe.to_device(stack), psf, 30.0, 0.01))
    hp, wp, _, _ = pad_extents(h, w)
    middle = "wiener_spectral_t" if hp >= 512 else "fwd_wiener_rows"
    other = "fwd_wiener_rows" if hp >= 512 else "wiener_spectral_t"
    assert launch_counts[middle] == 1 and launch_counts[other] == 0, dict(launch_counts)
    assert launch_counts["lab_l_sum_partials"] == 1 and launch_counts["wb_encode_u8"] == 1
    H = psf_spectrum_planes(make_psf("motion", psf, 30.0, dev), hp, wp, PLAIN_OPS)
    out_p, planes_p = restore_stack(torch.as_tensor(stack, device=dev), H, 0.01,
                                    white_balance=True, emit_planes=True,
                                    wb_stats_stride=stride, ops=PLAIN_OPS)
    assert np.abs(planes - planes_p.cpu().numpy()).max() <= 1e-4
    assert np.abs(out.astype(np.int32) - out_p.cpu().numpy().astype(np.int32)).max() <= 1


def test_plane_counts_past_65535(dev, gen):
    """A directory chunk of small frames packs more pairs than gridDim.y
    could hold: the one-dimensional grids cover them."""
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk
    from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as ws

    from fft_restoration_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    stack = torch.as_tensor(gen.integers(0, 256, (44_001, 3, 7, 3), dtype=np.uint8), device=dev)
    reset_launch_counts()
    a = fk.fft_rows_stack(stack, extent=(4, 8))
    assert launch_counts["fft_rows_t"] == 1
    a_p = fk.fft_rows_stack_plain(stack, extent=(4, 8))
    assert a[0].shape == (66_002, 8, 4)
    for o, r in zip(a, a_p):
        assert _rel(o, r) <= 1e-5
    h_re, h_im = (torch.as_tensor(gen.standard_normal((8, 4), dtype=np.float32), device=dev)
                  for _ in range(2))
    for fn, plain in ((ws.fwd_wiener_rows, ws.fwd_wiener_rows_plain),
                      (ws.wiener_spectral_t, ws.wiener_spectral_t_plain)):
        for o, r in zip(fn(*a_p, h_re, h_im, 0.01), plain(*a_p, h_re, h_im, 0.01)):
            assert _rel(o, r) <= 1e-5
    out, mm = fk.fft_rows_packed_out(*a_p, inverse=True)
    out_p, mm_p = fk.fft_rows_packed_out_plain(*a_p, inverse=True)
    assert _rel(out, out_p) <= 1e-5 and _rel(mm, mm_p) <= 1e-5
    # the row-major passes (csrc/fft_rows.cu) over the same pairs
    for kw in (dict(inverse=True), dict(ordering="natural")):
        for o, r in zip(fk.fft_rows(*a_p, **kw), fk.fft_rows_plain(*a_p, **kw)):
            assert _rel(o, r) <= 1e-5


SMOOTH = [(384, (3,)), (640, (5,)), (1152, (3, 3)), (1920, (3, 5)), (2304, (3, 3)),
          (3840, (3, 5))]


@pytest.mark.parametrize("n,rad", SMOOTH)
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_rows_mixed_radix(dev, gen, n, rad, inverse):
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk

    re, im = (torch.as_tensor(gen.standard_normal((2, 32, n), dtype=np.float32), device=dev)
              for _ in range(2))
    for transposed in (False, True):
        kw = dict(inverse=inverse, transposed=transposed, radices=rad)
        for o, r in zip(fk.fft_rows(re, im, **kw), fk.fft_rows_plain(re, im, **kw)):
            assert _rel(o, r) <= 1e-5
    out, mm = fk.fft_rows_packed_out(re, im, inverse=inverse, radices=rad)
    out_p, mm_p = fk.fft_rows_packed_out_plain(re, im, inverse=inverse, radices=rad)
    assert _rel(out, out_p) <= 1e-5 and _rel(mm, mm_p) <= 1e-5
    stack = torch.as_tensor(gen.integers(0, 256, (2, 21, n - 7, 3), dtype=np.uint8), device=dev)
    for o, r in zip(fk.fft_rows_stack(stack, extent=(32, n), radices=rad),
                    fk.fft_rows_stack_plain(stack, extent=(32, n), radices=rad)):
        assert o.shape == (3, n, 32) and _rel(o, r) <= 1e-5


@pytest.mark.parametrize("n,rad", SMOOTH)
def test_spectral_middles_mixed_radix(dev, gen, n, rad):
    from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as ws

    a_re, a_im = (torch.as_tensor(gen.standard_normal((2, 48, n), dtype=np.float32), device=dev)
                  for _ in range(2))
    h_re, h_im = (torch.as_tensor(gen.standard_normal((48, n), dtype=np.float32), device=dev)
                  for _ in range(2))
    a = (a_re, a_im, h_re, h_im)
    pairs = [(ws.wiener_spectral_t(*a, 0.01, rad), ws.wiener_spectral_t_plain(*a, 0.01, rad)),
             (ws.fwd_wiener_rows(*a, 0.01, rad), ws.fwd_wiener_rows_plain(*a, 0.01, rad))]
    for conj in (False, True):
        pairs.append((ws.spectral_conv_t(*a, conj, rad), ws.spectral_conv_t_plain(*a, conj, rad)))
    for ours, ref in pairs:
        for o, r in zip(ours, ref):
            assert _rel(o, r) <= 1e-5


# B2 and B7 on the stage-group engine (csrc/wiener_spectral.cu, s_plan):
# every length the kernels admit, every mode, plane heights that leave a
# ragged last row block (the kernels mask it), planes past one block
@pytest.mark.parametrize("n,rad", [(1 << s, ()) for s in range(1, 15)] + SMOOTH)
def test_spectral_middles_every_length(dev, gen, n, rad):
    from fft_restoration_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as ws

    for m in ((37, 6, 1) if n <= 4096 else (5, 1)):
        a_re, a_im = (torch.as_tensor(gen.standard_normal((3, m, n), dtype=np.float32),
                                      device=dev) for _ in range(2))
        h_re, h_im = (torch.as_tensor(gen.standard_normal((m, n), dtype=np.float32),
                                      device=dev) for _ in range(2))
        a = (a_re, a_im, h_re, h_im)
        reset_launch_counts()
        pairs = [(ws.wiener_spectral_t(*a, 0.01, rad), ws.wiener_spectral_t_plain(*a, 0.01, rad)),
                 (ws.fwd_wiener_rows(*a, 0.01, rad), ws.fwd_wiener_rows_plain(*a, 0.01, rad))]
        for conj in (False, True):
            pairs.append((ws.spectral_conv_t(*a, conj, rad),
                          ws.spectral_conv_t_plain(*a, conj, rad)))
        assert (launch_counts["wiener_spectral_t"], launch_counts["fwd_wiener_rows"],
                launch_counts["spectral_conv_t"]) == (1, 1, 2), dict(launch_counts)
        assert launch_counts["mixed_radix"] == 4 * bool(rad)
        for ours, ref in pairs:
            for o, r in zip(ours, ref):
                assert o.shape == r.shape and _rel(o, r) <= 1e-5, (m, _rel(o, r))


def test_spectral_middles_unaligned_spectrum(dev, gen):
    """A spectrum view that starts off a 16-byte boundary (the kernels read
    H as vectors: the wrapper copies it) gives the aligned result."""
    from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as ws

    m, n = 24, 512
    a_re, a_im = (torch.as_tensor(gen.standard_normal((2, m, n), dtype=np.float32), device=dev)
                  for _ in range(2))
    buf = torch.as_tensor(gen.standard_normal(2 * m * n + 2, dtype=np.float32), device=dev)
    h_re, h_im = buf[1:m * n + 1].view(m, n), buf[m * n + 1:-1].view(m, n)
    assert h_re.data_ptr() % 16 and h_re.is_contiguous()
    for fn in (ws.wiener_spectral_t, ws.fwd_wiener_rows):
        for o, r in zip(fn(a_re, a_im, h_re, h_im, 0.01),
                        fn(a_re, a_im, h_re.clone(), h_im.clone(), 0.01)):
            assert torch.equal(o, r)


@pytest.mark.parametrize("b,h,w,middle", [(1, 330, 640, "fwd_wiener_rows"),
                                          (2, 520, 300, "wiener_spectral_t")])
def test_smooth_pipeline_kernels_vs_plain_and_launches(dev, gen, b, h, w, middle):
    from fft_restoration_tpu_torch import BatchedWienerPipeline
    from fft_restoration_tpu_torch.host.blurgen import blur_image
    from fft_restoration_tpu_torch.models.pipeline import (
        PLAIN_OPS, pad_extents, psf_spectrum_planes, restore_stack,
    )
    from fft_restoration_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from fft_restoration_tpu_torch.ops.psf import make_psf

    stack = np.stack([blur_image(gen.integers(0, 256, (h, w, 3), dtype=np.uint8), 21, 60.0)
                      for _ in range(b)])
    pipe = BatchedWienerPipeline("cuda", pad_mode="smooth")
    reset_launch_counts()
    out, planes = (t.cpu().numpy() for t in pipe.run(pipe.to_device(stack), 21, 60.0, 0.01))
    assert launch_counts[middle] == 1, dict(launch_counts)
    # every FFT launch of the smooth path has cross levels: B1, the middle
    # (+ the inverse-T pass after B7), B3 and the PSF spectrum's two passes
    assert launch_counts["mixed_radix"] == launch_counts["fft_rows"] + 1, dict(launch_counts)
    hp, wp, rad_h, rad_w = pad_extents(h, w, "smooth")
    assert rad_h and rad_w
    H = psf_spectrum_planes(make_psf("motion", 21, 60.0, dev), hp, wp, PLAIN_OPS, (rad_h, rad_w))
    out_p, planes_p = restore_stack(torch.as_tensor(stack, device=dev), H, 0.01,
                                    white_balance=True, emit_planes=True, wb_stats_stride=1,
                                    pad_mode="smooth", ops=PLAIN_OPS)
    assert np.abs(planes - planes_p.cpu().numpy()).max() <= 1e-4
    assert np.abs(out.astype(np.int32) - out_p.cpu().numpy().astype(np.int32)).max() <= 1


@pytest.mark.parametrize("p,m,n", [(3, 2048, 2048), (2, 8, 4096), (1, 6, 2)])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_rows_natural(dev, gen, p, m, n, inverse):
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk
    from fft_restoration_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    re, im = (torch.as_tensor(gen.standard_normal((p, m, n), dtype=np.float32), device=dev)
              for _ in range(2))
    reset_launch_counts()
    ours = fk.fft_rows(re, im, inverse=inverse, ordering="natural")
    assert launch_counts["fft_rows"] == 1 and launch_counts["fft_rows_natural"] == 1
    for o, r in zip(ours, fk.fft_rows_plain(re, im, inverse=inverse, ordering="natural")):
        assert _rel(o, r) <= 1e-5
    z = torch.fft.ifft(torch.complex(re, im)) * n if inverse else torch.fft.fft(torch.complex(re, im))
    assert _rel(ours[0], z.real) <= 1e-5 and _rel(ours[1], z.imag) <= 1e-5


# every height the kernel takes (2 .. 16384), a ragged last strip and L > 1
COL_SHAPES = ([(3, 2048, 2048), (1, 4096, 64), (2, 128, 37), (2, 2, 5), (96, 256, 256)]
              + [(2, 1 << s, 37) for s in range(1, 15)])


@pytest.mark.parametrize("ordering", ["natural", "revorder"])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("l,h,w", COL_SHAPES)
def test_fft_cols(dev, gen, l, h, w, inverse, ordering):
    """B11 against its plain version; two launches bitwise equal."""
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk
    from fft_restoration_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    re, im = (torch.as_tensor(gen.standard_normal((l, h, w), dtype=np.float32), device=dev)
              for _ in range(2))
    reset_launch_counts()
    ours = fk.fft_cols(re, im, inverse=inverse, ordering=ordering)
    assert launch_counts["fft_cols"] == 1
    for o, r in zip(ours, fk.fft_cols_plain(re, im, inverse=inverse, ordering=ordering)):
        assert o.shape == (l, h, w) and _rel(o, r) <= 1e-5
    again = fk.fft_cols(re, im, inverse=inverse, ordering=ordering)
    assert all(torch.equal(a, o) for a, o in zip(again, ours))


def test_transpose_free_fft2(dev, gen):
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk

    re, im = (torch.as_tensor(gen.standard_normal((3, 2048, 2048), dtype=np.float32), device=dev)
              for _ in range(2))
    ours = fk.fft_cols(*fk.fft_rows(re, im, ordering="natural"), ordering="natural")
    z = torch.fft.fft2(torch.complex(re, im))
    assert _rel(ours[0], z.real) <= 1e-5 and _rel(ours[1], z.imag) <= 1e-5


@pytest.mark.parametrize("shape,offset", [((3, 2048, 2048), 0), ((3, 63, 130), 0),
                                          ((2, 64, 128), 1)])
def test_wiener_elem(dev, gen, shape, offset):
    """The float4 instance (aligned operands, plane % 4 == 0) and the
    scalar one (a 63 x 130 plane, not a multiple of 4; an operand one
    float past 16-byte alignment)."""
    from fft_restoration_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from fft_restoration_tpu_torch.ops.kernels.wiener import wiener_elem, wiener_elem_plain

    size = int(np.prod(shape))
    buf = torch.as_tensor(gen.standard_normal(size + offset, dtype=np.float32), device=dev)
    g_re = buf[offset:].view(shape)
    g_im = torch.as_tensor(gen.standard_normal(shape, dtype=np.float32), device=dev)
    h_re, h_im = (torch.as_tensor(gen.standard_normal(shape[-2:], dtype=np.float32), device=dev)
                  for _ in range(2))
    reset_launch_counts()
    ours = wiener_elem(g_re, g_im, h_re, h_im, 0.01)
    assert launch_counts["wiener_elem"] == 1
    for o, r in zip(ours, wiener_elem_plain(g_re, g_im, h_re, h_im, 0.01)):
        assert _rel(o, r) <= 1e-5


# B10 at every pow2 length 4 .. 16384 on 7 rows (a ragged last row block
# wherever a block holds more than one row), 1 and 3 planes, each `rows`
# knob whose rows fit a block's shared memory (None: the plan's)
B10_SHAPES = [(3, 2048, 2048, None), (3, 2048, 2048, 1), (3, 2048, 2048, 8), (2, 100, 256, 4),
              (1, 3, 16, 16)] + [
    (p, 7, 1 << s, rows) for s in range(2, 15) for p in (1, 3)
    for rows in (None, 1, 2, 4, 8, 16) if rows is None or 8 * rows * (1 << s) <= 232448]


@pytest.mark.parametrize("p,m,n,rows", B10_SHAPES)
def test_wiener_spectral_rows(dev, gen, p, m, n, rows):
    """B10 on the row store of spectral_s_kernel against its plain version;
    two launches bitwise equal."""
    from fft_restoration_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as ws

    a_re, a_im = (torch.as_tensor(gen.standard_normal((p, m, n), dtype=np.float32), device=dev)
                  for _ in range(2))
    h_re, h_im = (torch.as_tensor(gen.standard_normal((m, n), dtype=np.float32), device=dev)
                  for _ in range(2))
    reset_launch_counts()
    ours = ws.wiener_spectral_rows(a_re, a_im, h_re, h_im, 0.01, rows=rows)
    assert launch_counts["wiener_spectral_rows"] == 1
    for o, r in zip(ours, ws.wiener_spectral_rows_plain(a_re, a_im, h_re, h_im, 0.01, rows)):
        assert o.shape == (p, m, n) and _rel(o, r) <= 1e-5
    again = ws.wiener_spectral_rows(a_re, a_im, h_re, h_im, 0.01, rows=rows)
    assert all(torch.equal(a, o) for a, o in zip(again, ours))


# every length the kernel takes (4 .. 16384); 7 rows: a ragged last row
# block wherever a block holds more than one row
R4_SHAPES = [(6144, 2048), (5, 16), (3, 8)] + [(7, 1 << s) for s in range(2, 15)]


@pytest.mark.parametrize("b,n", R4_SHAPES)
@pytest.mark.parametrize("real", [True, False])
def test_fft_rows_radix4(dev, gen, b, n, real):
    """B12 against its plain version and the numpy simulation of the JAX
    kernel's order; two launches bitwise equal."""
    from fft_restoration_tpu_torch.ops.kernels import fft_radix4 as r4
    from fft_restoration_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    re = torch.as_tensor(gen.standard_normal((b, n), dtype=np.float32), device=dev)
    im = None if real else torch.as_tensor(gen.standard_normal((b, n), dtype=np.float32),
                                           device=dev)
    reset_launch_counts()
    ours = r4.fft_rows_radix4_fwd(re, im)
    assert launch_counts["fft_rows_radix4"] == 1
    for o, r in zip(ours, r4.fft_rows_radix4_fwd_plain(re, im)):
        assert _rel(o, r) <= 1e-5
    # the JAX kernel's digit-reversed order: the numpy simulation
    sim = r4._numpy_sim(re.cpu().numpy(), None if real else im.cpu().numpy())
    for o, r in zip(ours, sim):
        assert _rel(o.cpu().double(), torch.from_numpy(r)) <= 1e-5
    again = r4.fft_rows_radix4_fwd(re, im)
    assert all(torch.equal(a, o) for a, o in zip(again, ours))


def test_fft_backends_launches_and_full_float32(dev, gen):
    """fft2d's pallas backend runs fft_rows' natural instance (twice, rows
    then columns); matmul runs none of the FFT kernels and stays true
    float32 even with TF32 switched on around it."""
    from fft_restoration_tpu_torch.ops import fft as tfft
    from fft_restoration_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    re, im = (gen.standard_normal((3, 512, 256), dtype=np.float32) for _ in range(2))
    cpu = tfft.fft2d(torch.from_numpy(re), torch.from_numpy(im), backend="matmul")
    x = [torch.as_tensor(a, device=dev) for a in (re, im)]
    reset_launch_counts()
    ours = tfft.fft2d(*x, backend="pallas")
    assert launch_counts["fft_rows_natural"] == 2 and launch_counts["fft_rows"] == 2
    for o, r in zip(ours, cpu):
        assert _rel(o.cpu(), r) <= 1e-4
    reset_launch_counts()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ours = tfft.fft2d(*x, backend="matmul")
        assert torch.backends.cuda.matmul.allow_tf32  # restored on exit
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert not any(launch_counts.values()), dict(launch_counts)
    for o, r in zip(ours, cpu):
        assert _rel(o.cpu(), r) <= 1e-5


@pytest.mark.parametrize("backend", ["matmul", "radix2", "naive", "xla", "pallas"])
def test_generic_route_on_the_card_matches_cpu(gen, backend):
    from fft_restoration_tpu_torch import WienerDeblurPipeline
    from fft_restoration_tpu_torch.host.blurgen import blur_image

    img = blur_image(gen.integers(0, 256, (330, 640, 3), dtype=np.uint8), 21, 30.0)
    out, planes = WienerDeblurPipeline("cuda", fft_backend=backend).restore_with_planes(
        img, 21, 30.0)
    out_c, planes_c = WienerDeblurPipeline("cpu", fft_backend=backend).restore_with_planes(
        img, 21, 30.0)
    assert np.abs(planes - planes_c).max() <= 1e-5
    assert np.abs(out.astype(np.int32) - out_c.astype(np.int32)).max() <= 1


# B1's register-resident kernel (csrc/fft_rows_t.cu): every length the
# kernels admit, both directions, ragged live rows and columns, the rows
# past the live ones written as zeros by the kernel itself (its output is
# torch.empty)
T_LENGTHS = [(1 << s, ()) for s in range(1, 15)] + SMOOTH + [(1152, (3, 3)), (640, (5,))]


@pytest.mark.parametrize("n,rad", T_LENGTHS)
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_rows_t_every_length(dev, gen, n, rad, inverse):
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk
    from fft_restoration_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    big_m = 37 if n <= 4096 else 5
    for m, w in ((big_m, n), (big_m - 3, max(1, n - 5)), (1, n)):
        re, im = (torch.as_tensor(gen.standard_normal((3, m, w), dtype=np.float32), device=dev)
                  for _ in range(2))
        kw = dict(inverse=inverse, transposed=True, extent=(big_m, n), radices=rad)
        reset_launch_counts()
        ours = fk.fft_rows(re, im[:2], **kw)  # the third pair's im reads as zero
        assert launch_counts["fft_rows_t"] == 1 == launch_counts["fft_rows"], dict(launch_counts)
        assert launch_counts["mixed_radix"] == bool(rad)
        for o, r in zip(ours, fk.fft_rows_plain(re, im[:2], **kw)):
            assert o.shape == (3, n, big_m) and _rel(o, r) <= 1e-5
            assert torch.all(o[..., m:] == 0)


@pytest.mark.parametrize("n,rad", [(256, ()), (2048, ()), (4096, ()), (384, (3,)), (2304, (3, 3)),
                                   (3840, (3, 5))])
@pytest.mark.parametrize("c", [1, 3, 5])
def test_fft_rows_t_stack_odd_channels(dev, gen, n, rad, c):
    """Stacks whose channel count is odd (the last pair's im a phantom
    plane for an odd B*C), ragged rows and columns, u8 and float32."""
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk

    b, h = 3, 19
    for dtype in (np.uint8, np.float32):
        x = (gen.integers(0, 256, (b, h, n - 3, c)).astype(dtype) if dtype == np.uint8
             else gen.standard_normal((b, h, n - 3, c), dtype=np.float32))
        stack = torch.as_tensor(x, device=dev)
        ours = fk.fft_rows_stack(stack, extent=(24, n), radices=rad)
        for o, r in zip(ours, fk.fft_rows_stack_plain(stack, extent=(24, n), radices=rad)):
            assert o.shape == (-(-b * c // 2), n, 24) and _rel(o, r) <= 1e-5


def test_fft_rows_t_u8_frame_pair_views(dev, gen):
    """The frame's channel-pair views (strided uint8 planes, an odd channel
    count) and a real-input PSF with 20 live rows of 2048."""
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk

    frame = torch.as_tensor(gen.integers(0, 256, (2000, 1999, 3), dtype=np.uint8), device=dev)
    c = frame.permute(2, 0, 1)
    for o, r in zip(fk.fft_rows(c[0::2], c[1::2], transposed=True, extent=(2048, 2048)),
                    fk.fft_rows_plain(c[0::2], c[1::2], transposed=True, extent=(2048, 2048))):
        assert _rel(o, r) <= 1e-5
    psf = torch.as_tensor(gen.random((20, 20), dtype=np.float32), device=dev)[None]
    ours = fk.fft_rows(psf, None, transposed=True, extent=(2048, 2048))
    for o, r in zip(ours, fk.fft_rows_plain(psf, None, transposed=True, extent=(2048, 2048))):
        assert _rel(o, r) <= 1e-5 and torch.all(o[..., 20:] == 0)


def test_kernels_do_not_spill():
    """-Xptxas -v of the build: no kernel instance spills registers."""
    from fft_restoration_tpu_torch.ops.kernels import _build

    _build.load()
    lines = [ln for ln in _build.build_log.splitlines() if "spill" in ln]
    assert lines and all("0 bytes spill stores, 0 bytes spill loads" in ln for ln in lines), \
        [ln for ln in lines if "0 bytes spill stores, 0 bytes spill loads" not in ln]


# B3/B6's register-resident kernel (csrc/fft_rows.cu): every length the
# kernels admit, both directions, both orderings (natural: pow2), ragged
# live rows and columns, the rows past the live ones written as zeros by
# the kernel itself (its output is torch.empty); the packed store with
# its partials
@pytest.mark.parametrize("n,rad", T_LENGTHS)
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_rows_row_major_every_length(dev, gen, n, rad, inverse):
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk
    from fft_restoration_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    big_m = 37 if n <= 4096 else 5
    for ordering in ("revorder",) if rad else ("revorder", "natural"):
        for m, w in ((big_m, n), (big_m - 3, max(1, n - 5)), (1, n)):
            re, im = (torch.as_tensor(gen.standard_normal((3, m, w), dtype=np.float32),
                                      device=dev) for _ in range(2))
            kw = dict(inverse=inverse, extent=(big_m, n), radices=rad, ordering=ordering)
            reset_launch_counts()
            ours = fk.fft_rows(re, im[:2], **kw)  # the third pair's im reads as zero
            assert launch_counts["fft_rows"] == 1 and launch_counts["fft_rows_t"] == 0
            assert launch_counts["fft_rows_natural"] == (ordering == "natural")
            assert launch_counts["mixed_radix"] == bool(rad)
            for o, r in zip(ours, fk.fft_rows_plain(re, im[:2], **kw)):
                assert o.shape == (3, big_m, n) and _rel(o, r) <= 1e-5
                assert torch.all(o[:, m:] == 0)
    pg = fk.rows_per_block(n, 64)
    for m in (pg, 4 * pg):
        re, im = (torch.as_tensor(gen.standard_normal((2, m, n), dtype=np.float32), device=dev)
                  for _ in range(2))
        out, mm = fk.fft_rows_packed_out(re, im, inverse=inverse, radices=rad)
        out_p, mm_p = fk.fft_rows_packed_out_plain(re, im, inverse=inverse, radices=rad)
        assert mm.shape == mm_p.shape == (2 * m // fk.rows_per_block(n, m), 4)
        assert _rel(out, out_p) <= 1e-5 and _rel(mm, mm_p) <= 1e-5


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("m", [1, 2, 4])
def test_fft_rows_packed_tiny_planes(dev, gen, n, m):
    """A block holds more rows than one partial (a thread's 16 slots need
    them): each partial is reduced from the rows the block stored."""
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk

    re, im = (torch.as_tensor(gen.standard_normal((3, m, n), dtype=np.float32), device=dev)
              for _ in range(2))
    out, mm = fk.fft_rows_packed_out(re, im)
    out_p, mm_p = fk.fft_rows_packed_out_plain(re, im)
    assert mm.shape == mm_p.shape and _rel(out, out_p) <= 1e-5 and _rel(mm, mm_p) <= 1e-5


def test_fft_rows_strided_u8_views(dev, gen):
    """The row-major passes over a frame's strided uint8 channel views and
    over a transposed (column-strided) float view: the element-wise
    fallback of the vector load."""
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk

    frame = torch.as_tensor(gen.integers(0, 256, (300, 500, 3), dtype=np.uint8), device=dev)
    c = frame.permute(2, 0, 1)
    f = torch.as_tensor(gen.standard_normal((2, 512, 256), dtype=np.float32), device=dev)
    for args, kw in (((c[0::2], c[1::2]), dict(extent=(512, 512))),
                     ((c[0::2], c[1::2]), dict(extent=(512, 512), inverse=True)),
                     ((c[0::2], c[1::2]), dict(extent=(512, 512), ordering="natural")),
                     ((f.transpose(1, 2), None), dict(inverse=True)),
                     ((f.transpose(1, 2)[:, :, 1:], None), dict(extent=(256, 512),
                                                                inverse=True))):
        for o, r in zip(fk.fft_rows(*args, **kw), fk.fft_rows_plain(*args, **kw)):
            assert _rel(o, r) <= 1e-5


# The MXU engine (fft_engine="mxu", csrc/fft_group_dft.cuh): each kernel at
# both precisions against its plain twin at the same precision. 'highest'
# (3xTF32) 1e-5 of the output's max. 'default' (one bf16 pass) 1e-5 where
# the group DFT reads the twin's float32 values (the bf16 units build with
# -fmad=false, so the forward stages' values are the twin's to the bit).
# B2's inverse group DFT rounds the forward products to bf16, and those
# differ from the twin's in the tensor cores' accumulation order: a bin
# beside a rounding edge takes the neighbouring bf16, which moves every
# output of its row by 2^-8 of the bin. On these normal spectra a bin near
# the max moves the output by ~1e-4 of its max at n = 2048 (the card read
# 1.26e-4); MXU_BF16_REL leaves room for a few such bins.
MXU_BF16_REL = 1e-3


@pytest.mark.parametrize("precision", ["default", "highest"])
@pytest.mark.parametrize("m,n,radices", [(256, 2048, ()), (64, 256, ()), (40, 128, ()),
                                         (48, 2304, (3, 3)), (16, 640, (5,))])
def test_mxu_fft_kernels(dev, gen, precision, m, n, radices):
    from fft_restoration_tpu_torch.ops.kernels import fft_kernel as fk
    from fft_restoration_tpu_torch.ops.kernels import wiener_spectral as ws

    E = dict(engine="mxu", precision=precision)
    mid_tol = 1e-5 if precision == "highest" else MXU_BF16_REL
    a, b, hr, hi = (torch.as_tensor(gen.standard_normal(s).astype(np.float32), device=dev)
                    for s in ((2, m, n), (2, m, n), (m, n), (m, n)))
    u8 = torch.as_tensor(gen.integers(0, 256, (m, n, 3), dtype=np.uint8), device=dev)
    c = u8.permute(2, 0, 1)
    cases = [
        (fk.fft_rows(c[0::2], c[1::2], transposed=True, radices=radices, **E),
         fk.fft_rows_plain(c[0::2], c[1::2], transposed=True, radices=radices, **E), 1e-5),
        (fk.fft_rows(a, b, radices=radices, **E), fk.fft_rows_plain(a, b, radices=radices, **E),
         1e-5),
        (fk.fft_rows(a, b, inverse=True, transposed=True, radices=radices, **E),
         fk.fft_rows_plain(a, b, inverse=True, transposed=True, radices=radices, **E), 1e-5),
        (ws.fwd_wiener_rows(a, b, hr, hi, 0.01, radices, **E),
         ws.fwd_wiener_rows_plain(a, b, hr, hi, 0.01, radices, **E), 1e-5),
        (ws.wiener_spectral_t(a, b, hr, hi, 0.01, radices, **E),
         ws.wiener_spectral_t_plain(a, b, hr, hi, 0.01, radices, **E), mid_tol),
        (ws.spectral_conv_t(a, b, hr, hi, True, radices, **E),
         ws.spectral_conv_t_plain(a, b, hr, hi, True, radices, **E), mid_tol),
    ]
    if m % fk.rows_per_block(n, m) == 0:
        cases.append((fk.fft_rows_packed_out(a, b, radices=radices, **E),
                      fk.fft_rows_packed_out_plain(a, b, radices=radices, **E), 1e-5))
    for ours, ref, tol in cases:
        for o, r in zip(ours, ref):
            assert _rel(o, r) <= tol


def test_mxu_pipeline_counts_and_tiers(dev):
    from fft_restoration_tpu_torch import WienerDeblurPipeline
    from fft_restoration_tpu_torch.host.blurgen import blur_image
    from fft_restoration_tpu_torch.host.oracle import restore_frame_channels
    from fft_restoration_tpu_torch.host.verify import channels_equal
    from fft_restoration_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    img = blur_image(np.random.default_rng(3).integers(0, 256, (330, 640, 3), dtype=np.uint8),
                     15, 30.0)
    oracle = restore_frame_channels(img, 15, 30.0, 0.01)
    for precision, tier in (("highest", "inf"), ("default", "gpu")):
        reset_launch_counts()
        _, planes = WienerDeblurPipeline("cuda", fft_engine="mxu", mxu_precision=precision
                                         ).restore_with_planes(img, 15, 30.0)
        for k in ("fft_rows_t", "fft_rows", "fft_rows_packed_out", "wiener_spectral_t"):
            assert launch_counts[f"{k}_mxu_{precision}"] >= 1, k
        assert channels_equal(planes, oracle, tier).passed
