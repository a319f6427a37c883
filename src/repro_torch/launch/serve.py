"""LM serving: decode requests scheduled through the port's
Executor (`repro/launch/serve.py`).

The paper's workload shape — many evaluations of one expensive map with
widely varying per-request cost — is LM serving with mixed prompt
lengths.  This module wraps an LM's prefill + decode loop as an
UM-Bridge `Model` and pushes requests through the persistent-worker
executor (HQ semantics: the server, its weights on the card, is kept) or
the naive per-request mode (SLURM semantics: every request builds a
fresh server).  The reference's fresh server pays a jit compile; the
port compiles nothing per server, so a fresh server pays its weight init
on the device and its warm-up request.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
        --requests 16 --max-new 8 --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from repro_torch import configs
from repro_torch import device as device_lib
from repro_torch.core import EvalRequest, Executor, LambdaModel
from repro_torch.core.metrics import summarize
from repro_torch.launch.steps import (make_bucketed_prefill_step,
                                      make_decode_step)
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig


class LMServer:
    """A persistent LM model server: holds the weights on its device.

    Prompts of attention archs are right-padded to power-of-two buckets,
    as in the reference (whose warm jit cache then hits across lengths);
    causal masking keeps the padded KV rows unread until decode overwrites
    them position by position.  Weights are drawn from a `torch.Generator`
    seeded with `seed`, on the port's selected device."""

    def __init__(self, cfg: ModelConfig, *, batch: int = 1,
                 max_len: int = 256, seed: int = 0, min_bucket: int = 16):
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.min_bucket = min_bucket
        self.device = device_lib.get()
        self.params = model_lib.init_params(cfg, seed, self.device)
        self._prefill = make_bucketed_prefill_step(cfg)
        self._decode = make_decode_step(cfg)

    def warmup(self, prompt_len: int = 8):
        self.generate(np.zeros((self.batch, prompt_len), np.int32), 1)

    def _bucket(self, s: int) -> int:
        # Recurrent archs (SSM/RWKV/hybrid) integrate every input token
        # into their state — right-padding would corrupt it (causal
        # masking only protects attention caches).  They use exact
        # lengths; attention archs bucket.
        if self.cfg.block_kind != "attn+mlp":
            return s
        b = self.min_bucket
        while b < s:
            b *= 2
        return min(b, self.max_len)

    @torch.no_grad()
    def generate(self, prompt_tokens: np.ndarray, max_new: int
                 ) -> np.ndarray:
        b, s = prompt_tokens.shape
        if b != self.batch:
            raise ValueError(f"server batch is {self.batch}, got {b} prompts")
        bucket = self._bucket(s)
        padded = np.zeros((b, bucket), np.int64)
        padded[:, :s] = prompt_tokens
        dev, vocab = self.device, self.cfg.vocab_size
        cache = model_lib.init_cache(self.cfg, b, self.max_len, dev)
        logits, cache = self._prefill(
            self.params, {"tokens": torch.as_tensor(padded, device=dev)},
            cache, torch.full((b,), s - 1, device=dev))
        tok = logits[:, :vocab].argmax(-1)
        outs = [tok]
        for i in range(max_new - 1):
            logits, cache = self._decode(self.params, cache,
                                         {"tokens": tok[:, None]}, s + i)
            tok = logits[:, :vocab].argmax(-1)
            outs.append(tok)
        return torch.stack(outs, 1).cpu().numpy()


def make_lm_model_factory(cfg: ModelConfig, *, max_len: int = 256,
                          seed: int = 0):
    """UM-Bridge model factory: parameters = [prompt tokens]; config may
    set max_new.  Request cost scales with prompt length + new tokens —
    the mixed-cost profile the scheduler is for."""

    def factory():
        server = LMServer(cfg, batch=1, max_len=max_len, seed=seed)

        def fn(parameters, config):
            prompt = np.asarray(parameters, np.int64).reshape(1, -1)
            max_new = int((config or {}).get("max_new", 8))
            out = server.generate(prompt, max_new)
            return [out[0].tolist()]

        return LambdaModel(f"lm-{cfg.name}", fn, input_size=-1,
                           output_size=-1, warmup_fn=server.warmup)

    return factory


def serve_benchmark(arch: str, *, n_requests: int = 16, max_new: int = 8,
                    n_workers: int = 2, persistent: bool = True,
                    max_len: int = 256, seed: int = 0,
                    reduced: bool = True, min_prompt: int = 4) -> Dict:
    """Serve `n_requests` prompts of lengths drawn (from `seed`) in
    [min_prompt, max_len // 2) through the Executor.  Returns the wall
    time, the summary, the task records and the tokens generated."""
    cfg = configs.get_reduced(arch) if reduced else configs.get(arch)
    rng = np.random.default_rng(seed)
    lens = rng.integers(min_prompt, max_len // 2, n_requests)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).tolist()
               for n in lens]
    factory = make_lm_model_factory(cfg, max_len=max_len, seed=seed)
    name = f"lm-{cfg.name}"
    t0 = time.monotonic()
    with Executor({name: factory}, n_workers=n_workers,
                  persistent_servers=persistent,
                  name="hq" if persistent else "slurm") as ex:
        reqs = [EvalRequest(name, p, config={"max_new": max_new},
                            time_request=0.001 * len(p))
                for p in prompts]
        results = ex.run_all(reqs, timeout=1200.0)
        recs = ex.records()
    wall = time.monotonic() - t0
    failed = [r for r in results if r.status != "ok"]
    if failed:
        raise RuntimeError(f"{len(failed)} of {len(results)} requests "
                           f"failed: {failed[0]}")
    summary = summarize(f"serve-{arch}", "hq" if persistent else "slurm",
                        recs)
    return {"wall": wall, "summary": summary, "records": recs,
            "tokens": sum(len(r.value[0]) for r in results)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b",
                    choices=list(configs.ARCH_NAMES))
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args()
    device_lib.set_device(args.device)
    device_lib.strict_numerics()
    for persistent in (True, False):
        out = serve_benchmark(args.arch, n_requests=args.requests,
                              max_new=args.max_new, n_workers=args.workers,
                              persistent=persistent, max_len=args.max_len,
                              reduced=not args.full)
        s = out["summary"]
        mode = "persistent (HQ)" if persistent else "per-request (SLURM)"
        print(f"[serve {args.arch} on {args.device}] {mode:22s} "
              f"wall={out['wall']:.2f}s cpu={s.total_cpu_time:.2f}s "
              f"overhead={s.scheduling_overhead:.3f}s SLR={s.slr:.2f}")


if __name__ == "__main__":
    main()
