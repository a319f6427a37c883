"""Model checkpoints: save and restore of parameter and optimizer trees
(the port of `repro/checkpoint/checkpoint.py`).

The file format is the reference's, so that a checkpoint written by either
package loads in the other:
  * one `.npz` per step, every leaf stored under its key path joined by
    `/` (dict keys in sorted order, as `jax.tree_util` flattens them),
    plus `__meta__` (JSON: the step and `extra`);
  * npz has no bf16 codec: bf16 leaves are staged as f32 on disk and cast
    back to the dtype of the `like` tree on load;
  * a file is published atomically (tmpfile in the same directory, then
    `os.replace`), so a crash mid-write never corrupts the latest one;
  * `CheckpointManager` snapshots to host memory synchronously, writes in
    a background thread (`wait()` joins it) and keeps the last `keep`
    steps.

Trees are nested dicts, lists and tuples whose leaves are torch tensors
or numpy arrays.  Where the reference reshards onto `shardings` on load,
the port places leaves on one `device`.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import threading
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_SEP = "/"


def _with_paths(tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) in `jax.tree_util`'s order: dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _with_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _with_paths(v, prefix + (i,))
    else:
        yield prefix, tree


def _key(path: Tuple) -> str:
    return _SEP.join(str(p) for p in path)


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array; bf16 (or any type npz cannot hold) as
    f32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype not in (torch.float32, torch.float64, torch.float16,
                           torch.int8, torch.int16, torch.int32, torch.int64,
                           torch.uint8, torch.bool):
            t = t.float()
        return t.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "fiub?c":
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {_key(path): _host(leaf) for path, leaf in _with_paths(tree)}


def save_pytree(path: os.PathLike, tree, step: Optional[int] = None,
                extra: Optional[Dict[str, Any]] = None) -> Path:
    """Atomic single-file save (tmpfile + rename)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)
    meta = {"step": step, "extra": extra or {}}
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta), **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _restore_leaf(arr: np.ndarray, like, device):
    if isinstance(like, torch.Tensor):
        dev = torch.device(device) if device is not None else (
            like.device if like.device.type != "meta" else torch.device("cpu"))
        return torch.as_tensor(arr).to(device=dev, dtype=like.dtype)
    want = getattr(like, "dtype", arr.dtype)
    return arr if arr.dtype == want else arr.astype(want)


def load_pytree(path: os.PathLike, like, *, device=None):
    """Restore into the structure of `like` -> (tree, meta).  Each leaf
    takes the dtype of `like`'s leaf; a torch leaf comes back on `device`
    (default: `like`'s device, the CPU for a `meta` leaf), a numpy leaf as
    numpy.  Leaves are read one at a time."""
    def build(node, prefix, data):
        if isinstance(node, dict):
            return {k: build(node[k], prefix + (k,), data) for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, prefix + (i,), data)
                              for i, v in enumerate(node))
        key = _key(prefix)
        if key not in data.files:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        return _restore_leaf(data[key], node, device)

    with np.load(Path(path), allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        tree = build(like, (), data)
    return tree, meta


_STEP_RE = re.compile(r"step_(\d+)\.npz$")


def latest_step(ckpt_dir: os.PathLike) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(m.group(1)) for p in ckpt_dir.iterdir()
             if (m := _STEP_RE.search(p.name))]
    return max(steps) if steps else None


class CheckpointManager:
    """Async, retention-managed checkpointing for the training loop."""

    def __init__(self, ckpt_dir: os.PathLike, keep: int = 3,
                 async_save: bool = True):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None

    def _path(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}.npz"

    def save(self, step: int, tree, extra: Optional[Dict] = None):
        # snapshot to host memory synchronously (cheap), write async
        host = _flatten(tree)

        def _write():
            save_pytree(self._path(step), host, step=step, extra=extra)
            self._gc()

        self.wait()
        if self.async_save:
            self._pending = threading.Thread(target=_write, daemon=True)
            self._pending.start()
        else:
            _write()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self):
        steps = sorted(int(_STEP_RE.search(p.name).group(1))
                       for p in self.dir.iterdir()
                       if _STEP_RE.search(p.name))
        for s in steps[:-self.keep]:
            try:
                self._path(s).unlink()
            except OSError:
                pass

    def restore_latest(self, like, *, device=None):
        self.wait()
        step = latest_step(self.dir)
        if step is None:
            return None, None
        return load_pytree(self._path(step), like, device=device)

    def restore(self, step: int, like, *, device=None):
        self.wait()
        return load_pytree(self._path(step), like, device=device)
