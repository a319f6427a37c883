"""Shared helpers for the `repro_torch` differential tests: carrying a
`repro` posterior across to the port, and the device fixtures."""
import numpy as np
import pytest
import torch

from repro_torch import device


def export_posterior(post) -> dict:
    """A `repro.uq.gp.GPPosterior` as the numpy dict that
    `repro_torch.uq.gp.posterior_from_numpy` takes."""
    return {"params": {k: np.asarray(v)
                       for k, v in post.params.tree().items()},
            "x": np.asarray(post.x), "y": np.asarray(post.y),
            "y_mean": np.asarray(post.y_mean),
            "y_std": np.asarray(post.y_std), "chol": np.asarray(post.chol),
            "alpha": np.asarray(post.alpha), "kind": post.kind}


def np32(t) -> np.ndarray:
    """A result of either package as a numpy f32 array."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


@pytest.fixture(scope="module")
def on_cpu():
    """Run the port on the CPU for the test module, then restore the
    default.  Module-scoped fixtures that call the port depend on it."""
    device.set_device("cpu")
    yield
    device.set_device("cuda")
