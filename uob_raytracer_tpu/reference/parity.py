"""Boundary-aware image parity, shared by the tests and ``chip_smoke.py``."""
from __future__ import annotations

import numpy as np


def assert_images_match(img, ref, *, outlier_frac=0.005, outlier_bound=0.45,
                        tight=3e-4, what=""):
    """Boundary-aware image parity.

    XLA's CPU code contracts mul-add chains into FMAs, and XLA's GPU code
    divides and takes square roots approximately; NumPy does neither. An
    ulp of difference can flip marginal visibility comparisons (nearest-hit
    and shadow tests) on a handful of edge pixels, each off by at most a
    single shadow sample or hit reassignment. So: almost every pixel must
    match tightly, and the rare boundary pixels must stay bounded. The
    bound: one flipped shadow sample contributes up to
    light_color * lambert / S = 16 * ~0.25 / 10 ≈ 0.4 at the closest
    shaded points, so 0.45 accommodates a worst-case single flip without
    admitting a two-flip or structural error.

    Returns (share of pixels over ``tight``, worst pixel difference).
    """
    img = np.asarray(img)
    ref = np.asarray(ref)
    assert img.shape == ref.shape, f"{what}: {img.shape} vs {ref.shape}"
    diff = np.abs(img - ref).max(axis=-1)
    frac = float((diff > tight).mean())
    assert frac <= outlier_frac, (
        f"{what}: {frac:.2%} pixels differ by more than {tight} "
        f"(max {diff.max():.4f})")
    assert diff.max() <= outlier_bound, (
        f"{what}: worst-pixel difference {diff.max():.4f} exceeds "
        f"{outlier_bound} — not a boundary flip")
    return frac, float(diff.max())
