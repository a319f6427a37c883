"""Quasilinear quantity-of-interest integral (paper eq. (5)).

    Q_ql = Q0 * Lambda^(a-1) * (1/(rho* c_s)) *
           Int dk_y (1/theta0_max) Int_0^theta0_max dtheta0
              [ Q_l(k_y, theta0) / Q_l(k_y, theta0) ]_s * Lambda_hat(k_y, theta0)

The integrand needs the linear growth rate / mode frequency at every
quadrature node (k_y, theta0) — each node is one forward-model evaluation
(GS2 proxy or GP surrogate), which is exactly the mixed-cost workload the
paper schedules.  Two estimators:

  * `quadrature`: tensor-product trapezoid over a (k_y, theta0) grid; the
    node evaluations are returned as a request list so the load balancer
    can distribute them (the paper's end-goal workload).
  * `bayesian_quadrature`: a GP over the integrand with max-variance
    acquisition — adaptive node placement, integral mean +/- uncertainty
    (the paper's 'future exploration' adaptive setting, §VI).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

Q0 = 1.0
ALPHA = 1.5
RHO_STAR_CS = 1.0
THETA0_MAX = np.pi / 2


def saturation_weight(ky: np.ndarray, theta0: np.ndarray) -> np.ndarray:
    """Lambda_hat(k_y, theta0): the saturation-rule spectral weight.

    Standard quasilinear shape: peaked at intermediate k_y, decaying with
    ballooning angle (cf. eq. (3.6) of Giacomin et al. 2024)."""
    return (ky ** 2 / (1.0 + ky ** 4)) * np.exp(-0.5 * (theta0 / 0.7) ** 2)


def quasilinear_integrand(growth: np.ndarray, freq: np.ndarray,
                          ky: np.ndarray, theta0: np.ndarray) -> np.ndarray:
    """Flux-ratio integrand from linear-mode outputs: unstable modes
    (growth > 0) contribute gamma/k_y^2-weighted flux."""
    gamma_eff = np.maximum(growth, 0.0)
    flux_ratio = gamma_eff / (1.0 + 0.2 * np.abs(freq))
    return flux_ratio * saturation_weight(ky, theta0)


@dataclasses.dataclass
class QoIResult:
    value: float
    n_evals: int
    uncertainty: float = 0.0


def quadrature_nodes(base_params: np.ndarray, n_ky: int = 8,
                     n_theta0: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Return ([n_ky*n_theta0, 7] model inputs, [n,2] (ky,theta0) nodes).

    base_params fixes the 5 thermodynamic inputs; the integration runs
    over (binormal wavelength k_y, ballooning angle theta0 ~ folded into
    magnetic shear offset) per the quasilinear rule."""
    kys = np.linspace(0.1, 1.0, n_ky)
    th0s = np.linspace(0.0, THETA0_MAX, n_theta0)
    grid = np.stack(np.meshgrid(kys, th0s, indexing="ij"), -1).reshape(-1, 2)
    inputs = np.tile(np.asarray(base_params, float), (len(grid), 1))
    inputs[:, 6] = grid[:, 0]                        # k_y
    inputs[:, 1] = inputs[:, 1] + 0.3 * grid[:, 1]   # theta0 -> shear offset
    return inputs, grid


def integrate_from_evals(outputs: Sequence[Sequence[float]],
                         nodes: np.ndarray, n_ky: int,
                         n_theta0: int) -> QoIResult:
    """Trapezoid the integrand given model outputs at the grid nodes."""
    out = np.asarray(outputs, float)
    growth, freq = out[:, 0], out[:, 1]
    f = quasilinear_integrand(growth, freq, nodes[:, 0], nodes[:, 1])
    f = f.reshape(n_ky, n_theta0)
    kys = np.linspace(0.1, 1.0, n_ky)
    th0s = np.linspace(0.0, THETA0_MAX, n_theta0)
    inner = np.trapezoid(f, th0s, axis=1) / THETA0_MAX
    outer = np.trapezoid(inner, kys)
    value = Q0 * (1.0 ** (ALPHA - 1)) / RHO_STAR_CS * outer
    return QoIResult(value=float(value), n_evals=len(out))


def quadrature(model_fn: Callable[[np.ndarray], Tuple[float, float]],
               base_params: np.ndarray, n_ky: int = 8, n_theta0: int = 8
               ) -> QoIResult:
    """Direct tensor-quadrature estimator (embarrassingly parallel nodes)."""
    inputs, nodes = quadrature_nodes(base_params, n_ky, n_theta0)
    outputs = [model_fn(x) for x in inputs]
    return integrate_from_evals(outputs, nodes, n_ky, n_theta0)


def bayesian_quadrature(model_fn: Callable[[np.ndarray], Tuple[float, float]],
                        base_params: np.ndarray, n_init: int = 6,
                        n_adaptive: int = 10, seed: int = 0,
                        candidate_grid: int = 16,
                        backend: str = "exact") -> QoIResult:
    """Adaptive GP quadrature: start from a small LHS design over
    (k_y, theta0), repeatedly evaluate the max-posterior-variance node,
    estimate the integral from the GP mean on a dense grid.  The
    dependency chain (each new node depends on the GP conditioned on all
    previous) is the paper's 'loosely dependent tasks' future workload.

    `backend` selects the conditioning engine (`repro_torch.uq.engine`): the
    acquisition loop conditions once per node, so "incremental" turns
    its cumulative cost from O(Σn³) to O(Σn²); "exact" (default) is the
    reference refit path."""
    from repro_torch.uq import engine as engine_lib
    rng = np.random.default_rng(seed)
    lo = np.array([0.1, 0.0])
    hi = np.array([1.0, THETA0_MAX])

    def eval_node(node: np.ndarray) -> float:
        x = np.asarray(base_params, float).copy()
        x[6] = node[0]
        x[1] = x[1] + 0.3 * node[1]
        g, fq = model_fn(x)
        return float(quasilinear_integrand(np.array(g), np.array(fq),
                                           node[0], node[1]))

    nodes = lo + rng.random((n_init, 2)) * (hi - lo)
    vals = np.array([eval_node(nd) for nd in nodes])
    engine = engine_lib.fit_engine(nodes, vals, backend, steps=100)

    cand = np.stack(np.meshgrid(np.linspace(0.1, 1.0, candidate_grid),
                                np.linspace(0.0, THETA0_MAX, candidate_grid),
                                indexing="ij"), -1).reshape(-1, 2)
    for _ in range(n_adaptive):
        _, var = engine.predict(cand)
        nxt = cand[int(np.argmax(var.cpu().numpy()[:, 0]))]   # var is [S, M=1]
        engine = engine.condition(nxt[None], np.array([eval_node(nxt)]))

    mean, var = engine.predict(cand)
    f = mean.cpu().numpy()[:, 0].reshape(candidate_grid, candidate_grid)
    kys = np.linspace(0.1, 1.0, candidate_grid)
    th0s = np.linspace(0.0, THETA0_MAX, candidate_grid)
    inner = np.trapezoid(f, th0s, axis=1) / THETA0_MAX
    value = Q0 / RHO_STAR_CS * np.trapezoid(inner, kys)
    # integral-uncertainty proxy: mean posterior sd over the grid x volume
    vol = (hi[0] - lo[0])
    unc = float(np.mean(np.sqrt(var.cpu().numpy())) * vol / THETA0_MAX)
    return QoIResult(value=float(value), n_evals=n_init + n_adaptive,
                     uncertainty=unc)
