"""Seeded samplers: Latin hypercube (the paper's GS2 input sampler) and
Halton quasi-Monte Carlo, over the paper's Table II parameter ranges."""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

# Table II: the seven GS2 input parameters and their ranges.
GS2_PARAM_RANGES: Tuple[Tuple[str, float, float], ...] = (
    ("safety_factor", 2.0, 9.0),
    ("magnetic_shear", 0.0, 5.0),
    ("electron_density_gradient", 0.0, 10.0),
    ("electron_temperature_gradient", 0.5, 6.0),
    ("beta", 0.0, 0.3),                      # plasma/magnetic pressure ratio
    ("collision_frequency", 0.0, 0.1),
    ("binormal_wavelength", 0.0, 1.0),
)


def latin_hypercube(n: int, ranges: Sequence[Tuple[str, float, float]] =
                    GS2_PARAM_RANGES, seed: int = 0) -> np.ndarray:
    """[n, d] LHS sample, seeded for repeatability (paper §IV-B: 'the input
    parameters for GS2 are sampled from a seeded Latin hypercube')."""
    rng = np.random.default_rng(seed)
    d = len(ranges)
    u = (rng.permuted(np.tile(np.arange(n), (d, 1)), axis=1).T
         + rng.random((n, d))) / n
    lo = np.array([r[1] for r in ranges])
    hi = np.array([r[2] for r in ranges])
    return lo + u * (hi - lo)


def _van_der_corput(n: int, base: int) -> np.ndarray:
    out = np.zeros(n)
    for i in range(n):
        f, x, k = 1.0, 0.0, i + 1
        while k > 0:
            f /= base
            x += f * (k % base)
            k //= base
        out[i] = x
    return out


_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def halton(n: int, ranges: Sequence[Tuple[str, float, float]] =
           GS2_PARAM_RANGES, skip: int = 20) -> np.ndarray:
    """[n, d] Halton QMC points scaled to `ranges`."""
    d = len(ranges)
    assert d <= len(_PRIMES)
    u = np.stack([_van_der_corput(n + skip, _PRIMES[i])[skip:]
                  for i in range(d)], axis=1)
    lo = np.array([r[1] for r in ranges])
    hi = np.array([r[2] for r in ranges])
    return lo + u * (hi - lo)
