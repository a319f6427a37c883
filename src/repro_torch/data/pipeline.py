"""Token data pipeline: deterministic synthetic LM stream + memmap corpus
(the port of `repro/data/pipeline.py`, numpy only).

Multi-host discipline: every host computes the *global* batch spec but
materialises only its own shard (`host_shard`), so the pipeline never
allocates global_batch arrays on one host.  Synthetic data is a seeded
function of (seed, step) — restartable from a checkpointed step with no
state files, and identical across runs (bitwise).  The port runs one
process on one card, so `host_shard` takes process 0 of 1 where the
reference asks `jax.process_index()` / `jax.process_count()`; the batches
equal the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


def host_shard(global_batch: int,
               process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> Tuple[int, int]:
    """(offset, size) of this host's slice of the global batch."""
    pi = 0 if process_index is None else process_index
    pc = 1 if process_count is None else process_count
    assert global_batch % pc == 0, (global_batch, pc)
    size = global_batch // pc
    return pi * size, size


@dataclasses.dataclass
class SyntheticLM:
    """Markov-flavoured synthetic tokens: next-token structure exists (so
    loss actually decreases) but generation is a pure seeded function of
    the step."""
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    embeddings_dim: int = 0          # >0 -> emit embeddings (audio/vlm stubs)

    def batch(self, step: int, *, process_index: Optional[int] = None,
              process_count: Optional[int] = None) -> Dict[str, np.ndarray]:
        off, size = host_shard(self.global_batch, process_index,
                               process_count)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, off]))
        if self.embeddings_dim:
            emb = rng.standard_normal(
                (size, self.seq_len, self.embeddings_dim)).astype(np.float32)
            labels = rng.integers(0, self.vocab_size,
                                  (size, self.seq_len), dtype=np.int32)
            return {"embeddings": emb, "labels": labels}
        # structured stream: x_{t+1} = (a * x_t + drift + noise) mod V
        a = 6364136223846793005 % self.vocab_size or 1
        x0 = rng.integers(0, self.vocab_size, (size, 1), dtype=np.int64)
        noise = (rng.random((size, self.seq_len - 1)) < 0.1)
        toks = [x0[:, 0]]
        for t in range(self.seq_len - 1):
            nxt = (toks[-1] * a + 7) % self.vocab_size
            rnd = rng.integers(0, self.vocab_size, size, dtype=np.int64)
            toks.append(np.where(noise[:, t], rnd, nxt))
        tokens = np.stack(toks, 1).astype(np.int32)
        return {"tokens": tokens}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


@dataclasses.dataclass
class MemmapCorpus:
    """Fixed token corpus in a flat binary file (np.memmap), sampled in
    seq_len windows.  `build_demo` writes a synthetic corpus to disk so
    the memmap path is exercised end-to-end without external data."""
    path: Path
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def __post_init__(self):
        self.path = Path(self.path)
        self._data = np.memmap(self.path, dtype=np.int32, mode="r")

    @staticmethod
    def build_demo(path: Path, vocab_size: int, n_tokens: int = 1 << 20,
                   seed: int = 0) -> "MemmapCorpus":
        rng = np.random.default_rng(seed)
        arr = rng.integers(0, vocab_size, n_tokens, dtype=np.int32)
        arr.tofile(path)
        return path

    def batch(self, step: int, *, process_index: Optional[int] = None,
              process_count: Optional[int] = None) -> Dict[str, np.ndarray]:
        off, size = host_shard(self.global_batch, process_index,
                               process_count)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, off]))
        max_start = len(self._data) - self.seq_len - 1
        starts = rng.integers(0, max_start, size)
        tokens = np.stack([np.asarray(self._data[s:s + self.seq_len])
                           for s in starts])
        return {"tokens": tokens.astype(np.int32)}


def make_pipeline(kind: str, *, vocab_size: int, seq_len: int,
                  global_batch: int, seed: int = 0,
                  embeddings_dim: int = 0, corpus_path: Optional[Path] = None):
    if kind == "synthetic":
        return SyntheticLM(vocab_size, seq_len, global_batch, seed,
                           embeddings_dim)
    if kind == "memmap":
        assert corpus_path is not None
        return MemmapCorpus(corpus_path, vocab_size, seq_len, global_batch,
                            seed)
    raise ValueError(kind)
