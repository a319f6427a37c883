"""Adaptive surrogate delegation (paper §VI: the stated future workflow).

"delegating costly simulation to the surrogate at points with low
uncertainty": for each requested input, query the GP posterior first —
if its predictive sd is below `sd_threshold`, accept the surrogate mean
(cheap); otherwise schedule the expensive forward model through the
executor and CONDITION the GP on the result, so later nearby requests
hit the cheap path.  The workload is therefore a mixed stream of
millisecond surrogate hits and minutes-equivalent simulator runs with a
data-dependent mix — exactly the scheduling profile the paper's load
balancer exists for.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import device as device_mod
from repro_torch.core.executor import Executor
from repro_torch.core.task import EvalRequest
from repro_torch.uq import engine as engine_lib
from repro_torch.uq import gp as gp_lib


@dataclasses.dataclass
class AdaptiveResult:
    outputs: np.ndarray              # [n, m] accepted outputs
    used_simulator: np.ndarray       # [n] bool — which requests ran the model
    posterior: gp_lib.GPPosterior    # final (enriched) surrogate
    n_sim_calls: int


def evaluate_stream(executor: Executor, model_name: str,
                    post: gp_lib.GPPosterior, inputs: np.ndarray, *,
                    sd_threshold: float = 0.05, timeout: float = 600.0,
                    batch_condition: bool = True,
                    backend: str = "exact") -> AdaptiveResult:
    """Process `inputs` in order, delegating to the surrogate where its
    uncertainty allows and to the scheduled simulator where it does not.

    `backend` picks the conditioning engine: the per-simulation
    `condition()` was an O(n³) refit each time on "exact" (the default,
    reference behaviour); "incremental" pays O(n²) per accepted
    simulation, which is what makes long delegation streams viable.  The
    result's `posterior` is the underlying `GPPosterior` on
    exact/incremental and the engine itself on "partitioned"."""
    engine = engine_lib.as_engine(post, backend)
    # the stream runs where the engine lives, which must be the port's
    # device: no card under the default device raises here
    device_mod.check(engine.device)
    inputs = np.asarray(inputs, np.float32)
    # the inputs go to the engine's device once, not once per predict
    inputs_dev = gp_lib.as_f32(inputs, engine.device)
    n = len(inputs)
    m = engine.n_outputs()
    outputs = np.zeros((n, m), np.float32)
    used_sim = np.zeros(n, bool)
    n_sim = 0

    for i, x in enumerate(inputs):
        x_dev = inputs_dev[i:i + 1]
        mean, var = engine.predict(x_dev)
        # the engine's tensors may lie on the card: read them on the host
        mean, var = mean.cpu().numpy(), var.cpu().numpy()
        # variance is per output column [1, M]; gate on the LEAST trusted
        # output — one confidently-wrong column must not unlock the
        # surrogate for the whole vector
        sd = float(np.max(np.sqrt(var[0])))
        if sd <= sd_threshold:
            outputs[i] = mean[0]
            continue
        req = EvalRequest(model_name, [x.tolist()],
                          time_request=None)       # unpredictable runtime
        executor.submit(req)
        res = executor.result(req.task_id, timeout)
        if res.status != "ok":
            # fault-tolerant degradation: accept the surrogate rather
            # than fail the stream; flagged via used_simulator=False
            outputs[i] = mean[0]
            continue
        y = np.asarray(res.value[0], np.float32)
        outputs[i] = y
        used_sim[i] = True
        n_sim += 1
        if batch_condition:
            engine = engine.condition(x_dev, y[None])
    return AdaptiveResult(outputs=outputs, used_simulator=used_sim,
                          posterior=getattr(engine, "post", engine),
                          n_sim_calls=n_sim)
