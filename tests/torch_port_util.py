"""Shared helpers for the `repro_torch` differential tests: carrying a
`repro` posterior across to the port, comparing records of the two
packages, running one case through both, and the device fixtures."""
import dataclasses
import math

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


def plain(obj):
    """A result of either package as plain comparable data: dataclasses
    and named tuples as tuples of their fields, NaN as a marker that
    equals itself."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            plain(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    if isinstance(obj, float) and math.isnan(obj):
        return "nan"
    return obj


def assert_records_equal(want, got) -> None:
    """Two record lists of either package, equal in order and in every
    field (NaN equal to NaN: a record that never started carries one)."""
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert plain(a) == plain(b), (a, b)


def carry_reference_fit(monkeypatch) -> None:
    """Make the port's runtime predictor install the posterior the JAX
    reference fits on the same data (carried across as numpy), so both
    sides schedule on the same hyperparameters; the fits themselves are
    compared at the NLML level in tests/test_torch_gp.py."""
    from repro.uq import gp as jgp
    from repro_torch.uq import engine as tengine
    from repro_torch.uq import gp as tgp

    def fit_engine(x, y, backend="exact", *, kind="rbf", steps=200,
                   lr=5e-2, max_points=None, **kw):
        assert backend in ("exact", "incremental")
        post = jgp.fit(x, y, kind=kind, steps=steps, lr=lr)
        return tengine.wrap_posterior(
            tgp.posterior_from_numpy(export_posterior(post), "cpu"),
            backend, max_points=max_points, **kw)
    monkeypatch.setattr(tengine, "fit_engine", fit_engine)


def twin(pair, body, *args):
    """`body(J, *args)` and `body(T, *args)`, for `pair = (J, T)`: the
    reference's modules and the port's, as namespaces a test file builds.
    The same case through both must give equal observations (`plain`).
    The body carries the reference test's own asserts, so each side is
    held to them too.  Returns the port's observation."""
    j, t = (body(p, *args) for p in pair)
    assert plain(j) == plain(t), (j, t)
    return t


@pytest.fixture(scope="module")
def on_cpu():
    """Run the port on the CPU for the test module, then restore the
    default.  Module-scoped fixtures that call the port depend on it."""
    device.set_device("cpu")
    yield
    device.set_device("cuda")
