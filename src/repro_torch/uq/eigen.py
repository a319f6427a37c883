"""eigen-100 / eigen-5000 benchmark tasks (paper §IV-B).

Dense non-symmetric eigenproblems solved with numpy.linalg.eig (LAPACK
_geev), memory-bound, deterministic per seed: 'matrices in the eigen-100
benchmark are the same for all 100 evaluations'.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.task import Model


def make_matrix(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)) / np.sqrt(n)


def solve_eigen(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return np.linalg.eig(a)


class EigenModel(Model):
    """UM-Bridge model wrapping the eigenproblem.  Input: a seed scalar;
    output: the spectral abscissa + spectral radius (2 scalars)."""

    def __init__(self, n: int, fixed_seed: Optional[int] = 0):
        super().__init__(f"eigen-{n}")
        self.n = n
        self.fixed_seed = fixed_seed
        self._cache: Dict[int, np.ndarray] = {}

    def get_input_sizes(self, config=None) -> List[int]:
        return [1]

    def get_output_sizes(self, config=None) -> List[int]:
        return [2]

    def _matrix(self, seed: int) -> np.ndarray:
        if seed not in self._cache:
            self._cache[seed] = make_matrix(self.n, seed)
        return self._cache[seed]

    def __call__(self, parameters, config=None):
        seed = (self.fixed_seed if self.fixed_seed is not None
                else int(parameters[0][0]))
        vals, _ = solve_eigen(self._matrix(seed))
        return [[float(np.max(vals.real)), float(np.max(np.abs(vals)))]]

    def cost_hint(self, parameters, config=None) -> float:
        # O(n^3) with LAPACK geev constants measured on the testbed
        return 2.5e-10 * self.n ** 3

    def warmup(self):
        self._matrix(self.fixed_seed if self.fixed_seed is not None else 0)
