"""String-keyed policy / predictor registration.

Mirrors the `BackendSpec` idiom in `repro_torch.core.backends` (the `BACKENDS`
dict + `get`): call sites name a policy ("fcfs", "sjf", "lpt", "pack",
"steal", "edf", the multi-tenant "fairshare", or the cluster-level
"broker") or predictor ("quantile", "gp", "none") by string, or pass a
configured instance straight through.
Downstream work (surrogate-offload routing, SLO-aware admission) plugs
in with `@register_policy("my-policy")` — no core-module edits.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

POLICIES: Dict[str, Callable[..., Any]] = {}
PREDICTORS: Dict[str, Optional[Callable[..., Any]]] = {"none": None}


def register_policy(name: str):
    def deco(cls):
        POLICIES[name] = cls
        return cls
    return deco


def register_predictor(name: str):
    def deco(cls):
        PREDICTORS[name] = cls
        return cls
    return deco


def make_policy(spec: Union[str, Any], predictor: Any = None):
    """Resolve a policy name or pass an instance through.  A predictor
    given here is bound onto the policy unless it already has one."""
    if isinstance(spec, str):
        try:
            cls = POLICIES[spec]
        except KeyError:
            raise KeyError(f"unknown policy {spec!r}; "
                           f"registered: {sorted(POLICIES)}") from None
        return cls(predictor=predictor)
    if spec is None:
        return POLICIES["fcfs"](predictor=predictor)
    return spec.bind(predictor)


def make_predictor(spec: Union[str, Any, None]):
    """Resolve a predictor name ('none' and None both mean no predictor)
    or pass an instance through."""
    if spec is None:
        return None
    if isinstance(spec, str):
        try:
            cls = PREDICTORS[spec]
        except KeyError:
            raise KeyError(f"unknown predictor {spec!r}; "
                           f"registered: {sorted(PREDICTORS)}") from None
        return cls() if cls is not None else None
    return spec
