"""Differential verification against the oracle at the reference's tiers.

  l2   L2 norm of the difference <= 1.0
  inf  max abs difference <= 1e-3
  gpu  inf <= 1e-3, or PSNR >= 30 dB (the relaxed pass)

Every channel must pass on its own; the report carries the joint numbers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

L2_TOL = 1.0
INF_TOL = 1e-3
PSNR_TOL_DB = 30.0
TIERS = ("l2", "inf", "gpu")


@dataclass
class VerifyReport:
    l2: float
    inf: float
    psnr_db: float
    tier: str
    passed: bool

    def __str__(self) -> str:
        verdict = "[Success]" if self.passed else "[Error]"
        return (f"{verdict} tier={self.tier} L2={self.l2:.6f} "
                f"INF={self.inf:.6e} PSNR={self.psnr_db:.2f}dB")


def _psnr(mse: float, peak: float = 1.0) -> float:
    return float("inf") if mse == 0.0 else 10.0 * np.log10(peak * peak / mse)


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """PSNR in dB of two arrays at `peak` (1.0 for restored planes, 255.0
    for uint8 frames); inf when they are equal."""
    return _psnr(float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)),
                 peak)


def channels_equal(ours: np.ndarray, oracle: np.ndarray, tier: str = "gpu") -> VerifyReport:
    """Compare (C, H, W) (or (H, W)) restored planes with the oracle's."""
    if tier not in TIERS:
        raise ValueError(f"unknown tier {tier!r}")
    ours = np.asarray(ours, np.float64)
    oracle = np.asarray(oracle, np.float64)
    if ours.shape != oracle.shape:
        return VerifyReport(float("inf"), float("inf"), 0.0, tier, False)
    d = (ours - oracle).reshape(-1, *ours.shape[-2:])
    sq = (d * d).reshape(d.shape[0], -1)
    l2s = np.sqrt(sq.sum(axis=1))
    infs = np.abs(d).reshape(d.shape[0], -1).max(axis=1)
    mses = sq.mean(axis=1)
    if tier == "l2":
        ok = l2s <= L2_TOL
    elif tier == "inf":
        ok = infs <= INF_TOL
    else:
        ok = (infs <= INF_TOL) | (np.array([_psnr(m) for m in mses]) >= PSNR_TOL_DB)
    return VerifyReport(float(np.sqrt((l2s ** 2).sum())), float(infs.max()),
                        _psnr(float(mses.mean())), tier, bool(ok.all()))
