"""Richardson-Lucy on zero-padded frames against the float64 RL.

    python -m fft_restoration_tpu_torch.tools.rl_rim [--device cuda|cpu] [--seeds 1,2]

For motion-blurred 640x330 (PSF(50, 30)) and 200x230 (PSF(25, 30))
frames, 10 iterations, with and without the edge taper, it prints the
distance (planes max abs, and the share of values past 5e-2) from the
float64 RL of the frame's float32 planes x / 255 (true division) of:

  port        the port's RL on those planes;
  port_recip  the port's RL on planes made as x * (1/255), the reciprocal
              multiply a CUDA tensor computes for `x / 255.0` (one ulp off
              for about a quarter of the values);
  f64_recip   the float64 RL itself on the reciprocal planes: how far one
              ulp of input moves the reference;
  witness     an independent float32 RL (torch.fft) on the true-division
              planes.

With the taper, the planes are tapered by the port on the run's device
before each RL. One line per case, a JSON object last.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

ITERS = 10
TOL = 5e-2
CASES = (("640x330", 330, 640, 50), ("200x230", 230, 200, 25))


def blurred_frame(h: int, w: int, seed: int, length: int = 50, angle: float = 30.0):
    """A motion-blurred uint8 BGR frame: smooth random scene + detail."""
    from fft_restoration_tpu_torch.host.blurgen import blur_image

    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (h // 16 + 2, w // 16 + 2, 3)).astype(np.float64)
    scene = np.kron(coarse, np.ones((16, 16, 1)))[:h, :w]
    scene = np.clip(scene * 0.8 + rng.integers(0, 52, (h, w, 3)), 0, 255)
    return blur_image(scene.astype(np.uint8), length, angle)


def padded_frame_planes(img, reciprocal: bool = False, extent=None):
    """uint8 (h, w, 3) frame -> (3, hp, wp) float32 planes x / 255 (true
    division, or x * float32(1/255) with `reciprocal`), zero padded to
    extent=(hp, wp), by default the next powers of two: the RL input the
    pipeline builds."""
    from fft_restoration_tpu_torch.host.padding import next_power_of_two

    h, w = img.shape[:2]
    x = np.moveaxis(img, -1, 0).astype(np.float32)
    hp, wp = extent or (next_power_of_two(h), next_power_of_two(w))
    y = np.zeros((3, hp, wp), np.float32)
    y[:, :h, :w] = x * np.float32(1.0 / 255.0) if reciprocal else x / np.float32(255.0)
    return y


def rl_f64(y, psf, iters: int = ITERS, eps: float = 1e-6):
    """Richardson-Lucy in float64 np.fft on (C, hp, wp) padded planes (the
    formula of tests/test_richardson_lucy.py): (C, hp, wp) clipped."""
    pp = np.zeros(y.shape[-2:])
    pp[: psf.shape[0], : psf.shape[1]] = psf
    H = np.fft.fft2(pp)
    y = np.asarray(y, np.float64)
    x = y.copy()
    for _ in range(iters):
        conv = np.real(np.fft.ifft2(np.fft.fft2(x) * H))
        ratio = y / (conv + eps)
        x = np.maximum(x * np.real(np.fft.ifft2(np.fft.fft2(ratio) * np.conj(H))), 0.0)
    return np.clip(x, 0.0, 1.0)


def rl_f32_torch_fft(y, psf, iters: int = ITERS, eps: float = 1e-6, device="cuda"):
    """The same loop in float32 through torch.fft on `device`: an
    independent float32 RL, the witness of how far float32 itself sits
    from the float64 RL on an input. Used by no path of the port."""
    pp = torch.zeros(y.shape[-2:], dtype=torch.float32, device=device)
    pp[: psf.shape[0], : psf.shape[1]] = torch.as_tensor(psf, dtype=torch.float32)
    H = torch.fft.fft2(pp)
    y = torch.as_tensor(y, dtype=torch.float32, device=device)
    x = y.clone()
    for _ in range(iters):
        conv = torch.fft.ifft2(torch.fft.fft2(x) * H).real
        g = torch.fft.ifft2(torch.fft.fft2(y / (conv + eps)) * H.conj()).real
        x = torch.clamp_min(x * g, 0.0)
    return torch.clamp(x, 0.0, 1.0).cpu().numpy()


def _dist(a, ref):
    d = np.abs(a - ref)
    return dict(max_abs=float(d.max()), share_past=float((d > TOL).mean()))


def run_case(h, w, length, seed, taper, device):
    from fft_restoration_tpu_torch.models.edgetaper import edge_taper_planes
    from fft_restoration_tpu_torch.models.richardson_lucy import richardson_lucy_planes
    from fft_restoration_tpu_torch.ops.psf import make_psf

    img = blurred_frame(h, w, seed, length)
    psf = make_psf("motion", length, 30.0, device)
    planes = {}
    for name, recip in (("exact", False), ("recip", True)):
        y = torch.as_tensor(padded_frame_planes(img, recip), device=device)
        planes[name] = edge_taper_planes(y, psf, (h, w)) if taper else y
    psf64 = psf.cpu().numpy().astype(np.float64)
    ref = rl_f64(planes["exact"].cpu().numpy(), psf64)[:, :h, :w]
    out = {}
    for name, key in (("port", "exact"), ("port_recip", "recip")):
        x = richardson_lucy_planes(planes[key], psf, ITERS).cpu().numpy()[:, :h, :w]
        out[name] = _dist(x, ref)
    out["f64_recip"] = _dist(rl_f64(planes["recip"].cpu().numpy(), psf64)[:, :h, :w], ref)
    out["witness"] = _dist(rl_f32_torch_fft(planes["exact"].cpu().numpy(), psf.cpu().numpy(),
                                            device=device)[:, :h, :w], ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", default="1,2")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu")
        return 1
    res = {}
    for name, h, w, length in CASES:
        for seed in (int(s) for s in args.seeds.split(",")):
            for taper in (False, True):
                key = f"{name}{'_edgetaper' if taper else ''}_seed{seed}"
                res[key] = run_case(h, w, length, seed, taper, args.device)
                print(key, " ".join(f"{k} {v['max_abs']:.4g} ({v['share_past']:.2e})"
                                    for k, v in res[key].items()), flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
