"""GS2 proxy: a linear gyrokinetic-stability forward model in PyTorch,
the port of `repro/uq/gs2_proxy.py`.

What matters to the paper is GS2's scheduling profile: an initial-value
solver whose runtime varies unpredictably with seven physics inputs
because it iterates until an unstable mode converges.  The proxy keeps
that profile: it discretises a 1-D ballooning-space mode equation into an
m x m operator A(theta) built from the paper's Table II inputs and runs a
power iteration until the dominant-mode growth rate converges; the
iteration count — and hence the runtime — depends strongly and
non-obviously on the inputs.  Everything is f32, as in the reference.

Outputs mirror the GP surrogate's: (growth rate, mode frequency).
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch import device as device_mod

DEFAULT_RESOLUTION = 96
MAX_ITERS = 20_000
TOL = 1e-9

# The convergence test |lam - lam_prev| > TOL is read on the host once
# every CHECK_EVERY iterations (one device->host copy per block instead of
# one per iteration); the block's growth rates and iterates are kept on
# the device, so the first converged step and its iterate are recovered
# exactly.  A converged solve runs at most CHECK_EVERY - 1 extra steps.
CHECK_EVERY = 64

# GS2-equivalent calibration: wall-clock grows superlinearly in proxy
# iterations, scaled so the induced runtime distribution spans the paper's
# [1, 180] minute band with a long right tail.
GS2_RUNTIME_SCALE = 0.0143
GS2_RUNTIME_POWER = 2.0


def _theta(theta, dev: torch.device) -> torch.Tensor:
    if isinstance(theta, torch.Tensor):
        return theta.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(theta, np.float32), device=dev)


def build_operator(theta: torch.Tensor,
                   m: int = DEFAULT_RESOLUTION) -> torch.Tensor:
    """Assemble the m x m ballooning-mode operator from the 7 inputs (on
    theta's device)."""
    dev = theta.device
    q, shear, dens_grad, temp_grad, beta, nu, ky = (theta[i] for i in range(7))
    ky = 0.05 + ky                                 # avoid the ky=0 degeneracy
    grid = torch.linspace(-math.pi, math.pi, m, dtype=torch.float64,
                          device=dev).to(torch.float32)
    eye = torch.eye(m, dtype=torch.float32, device=dev)
    ones = torch.ones(m - 1, dtype=torch.float32, device=dev)
    # field-line bending: -(d^2/dtheta^2) with shear-dependent metric
    h = grid[1] - grid[0]
    bend = (1.0 + (shear * grid - beta * q * torch.sin(grid)) ** 2) / (q * q)
    lap = (torch.diag(ones, 1) + torch.diag(ones, -1) - 2.0 * eye) / (h * h)
    # instability drive: curvature * pressure gradients, localised at the
    # outboard midplane; damping: collisions + FLR
    drive = (ky * (temp_grad + 0.4 * dens_grad)
             * (torch.cos(grid) + (shear * grid - beta * q * torch.sin(grid))
                * torch.sin(grid)))
    damp = nu * 12.0 + 0.15 * ky * ky
    # bending is stabilising: +bend * lap (lap is negative-definite);
    # diag(bend) @ lap is a row scaling, exact either way
    a = ((bend[:, None] * lap) * 0.05
         + torch.diag(drive) * 0.5
         - damp * eye)
    # mode coupling (off-diagonal, shear-driven)
    c = torch.cos(grid[:-1])
    couple = 0.08 * shear * (torch.diag(c, 1) - torch.diag(c, -1))
    return a + couple


def solve(theta, m: int = DEFAULT_RESOLUTION
          ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Initial-value iteration -> (growth_rate, frequency, n_iters), the
    first two as 0-d tensors on the package's device."""
    dev = device_mod.get()
    a = build_operator(_theta(theta, dev), m)
    # shifted power iteration on exp(A dt) ~ (I + dt A + dt^2 A^2 / 2): the
    # dominant eigenvalue's real part is the growth rate.  dt respects the
    # explicit stability bound (Gershgorin radius).
    gersh = a.abs().sum(1).max()
    dt = torch.clamp(0.5 / torch.clamp(gersh, min=1e-6), max=0.02)
    prop = (torch.eye(m, dtype=torch.float32, device=dev) + dt * a
            + 0.5 * dt * dt * (a @ a))
    v = torch.ones(m, dtype=torch.float32, device=dev) / math.sqrt(m)
    w_blk = torch.empty((CHECK_EVERY, m), dtype=torch.float32, device=dev)
    nrm_blk = torch.empty(CHECK_EVERY, dtype=torch.float32, device=dev)
    lam_prev = np.float32(0.0)
    it = 0
    while True:
        steps = min(CHECK_EVERY, MAX_ITERS - it)
        for j in range(steps):
            torch.mv(prop, v, out=w_blk[j])
            torch.linalg.vector_norm(w_blk[j], out=nrm_blk[j])
            v = w_blk[j] / torch.clamp(nrm_blk[j], min=1e-30)
        lam_blk = torch.log(torch.clamp(nrm_blk[:steps], min=1e-30)) / dt
        lams = lam_blk.cpu().numpy()
        prev = np.concatenate([[lam_prev], lams[:-1]]).astype(np.float32)
        # the reference's loop condition, negated: stop at the first step
        # whose change is not above TOL (a NaN stops it too)
        stop = np.nonzero(~(np.abs(lams - prev) > TOL))[0]
        if len(stop) or it + steps >= MAX_ITERS:
            j = int(stop[0]) if len(stop) else steps - 1
            it += j + 1
            v = w_blk[j] / torch.clamp(nrm_blk[j], min=1e-30)
            growth = lam_blk[j]
            break
        it += steps
        lam_prev = lams[-1]
    # mode frequency: Rayleigh-quotient imaginary proxy via the
    # antisymmetric part of A
    asym = 0.5 * (a - a.T)
    freq = v @ (asym @ v)
    return growth, freq, it


def evaluate(theta, m: int = DEFAULT_RESOLUTION) -> Tuple[float, float]:
    g, f, _ = solve(theta, m)
    return float(g), float(f)


def make_solver(m: int = DEFAULT_RESOLUTION):
    """A solver for one model server.  The JAX reference salts a fresh
    jit here so that a fresh server pays a compile; eager PyTorch keeps
    no per-server executable, so a fresh server pays only what its first
    solve really costs on the device (allocations, the calling thread's
    first BLAS call)."""
    return functools.partial(evaluate, m=m)


def iteration_count(theta, m: int = DEFAULT_RESOLUTION) -> int:
    return solve(theta, m)[2]


def gs2_equivalent_runtime(theta, m: int = DEFAULT_RESOLUTION,
                           floor_s: float = 60.0,
                           cap_s: float = 10_800.0) -> float:
    """Map the proxy's iteration count onto GS2's wall-clock band
    ([1, 180] minutes on 8 cores, Table III) for the scheduling simulator."""
    it = iteration_count(theta, m)
    return float(np.clip(GS2_RUNTIME_SCALE * it ** GS2_RUNTIME_POWER,
                         floor_s, cap_s))


def runtime_table(thetas: np.ndarray, m: int = DEFAULT_RESOLUTION
                  ) -> np.ndarray:
    return np.array([gs2_equivalent_runtime(t, m) for t in thetas])
