"""Crash-safe JSON journal: atomic-publish snapshots for the broker
service (the port of `repro/checkpoint/journal.py`).

The atomic publish of model checkpoints — write to a tmpfile in the
destination directory, fsync, `os.replace` — applied to small JSON
state snapshots (queue contents, predictor state, billing).  (The
reference names its `save_pytree` here; the port's is in `checkpoint.py`
beside this module.)

The invariant the SIGKILL test pins: a crash at ANY instant leaves the
directory holding either the previous journal set intact or the new
file complete; a torn write is impossible to observe through `latest()`
because the tmpfile never matches the journal name pattern and the
rename is atomic on POSIX.

This module is stdlib-only: journal state is plain JSON — the same
files whichever package wrote them — and the broker service must be
importable on a login node that has no accelerator stack.

Recovery contract (`latest()`): newest LOADABLE journal wins.  Files
that fail to parse — e.g. hand-truncated by an operator, or written by
a pre-crash process on a filesystem without rename atomicity — are
skipped, not fatal: the service falls back to the previous snapshot
rather than refusing to start.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

_JOURNAL_RE = re.compile(r"journal_(\d+)\.json$")


class Journal:
    """Keep-N sequence of atomically-published JSON snapshots."""

    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.keep = int(keep)
        self.dir.mkdir(parents=True, exist_ok=True)
        latest = self.latest_seq()
        self._seq = latest if latest is not None else 0
        # fault injection (repro_torch.chaos `journal_torn`): the NEXT write
        # publishes a half-written payload directly under the journal
        # name — simulating a pre-rename-era torn write / non-atomic
        # filesystem — which `latest()` must skip on recovery
        self.torn_next = False

    def _path(self, seq: int) -> Path:
        return self.dir / f"journal_{seq:08d}.json"

    def seqs(self) -> List[int]:
        """Published sequence numbers, ascending."""
        out = []
        for p in self.dir.iterdir():
            m = _JOURNAL_RE.fullmatch(p.name)
            if m is not None:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_seq(self) -> Optional[int]:
        seqs = self.seqs()
        return seqs[-1] if seqs else None

    # -- writes ----------------------------------------------------------
    def write(self, state: Dict[str, Any]) -> Path:
        """Atomically publish one snapshot as the next sequence number.

        The payload is serialised BEFORE the tmpfile opens (a state dict
        that isn't JSON-able must fail loudly, not leave debris), fsynced
        before the rename (the rename must never become durable ahead of
        the data it points at), and garbage collection of old sequences
        runs only after the publish."""
        payload = json.dumps({"seq": self._seq + 1, "state": state})
        self._seq += 1
        path = self._path(self._seq)
        if self.torn_next:
            self.torn_next = False
            with open(path, "w") as f:
                f.write(payload[:max(len(payload) // 2, 1)])
            return path
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        # the rename is durable only once the DIRECTORY entry is synced:
        # without this, a power cut after os.replace can resurface the
        # old name (or neither), and recovery silently loses the newest
        # published snapshot
        self._fsync_dir()
        self._gc()
        return path

    def _fsync_dir(self) -> None:
        try:
            dfd = os.open(self.dir, os.O_RDONLY)
        except OSError:
            return                             # platform without dir-open
        try:
            os.fsync(dfd)
        except OSError:
            pass                               # fs without dir fsync
        finally:
            os.close(dfd)

    def _gc(self) -> None:
        if self.keep <= 0:
            return
        for seq in self.seqs()[:-self.keep]:
            try:
                self._path(seq).unlink()
            except OSError:
                pass                           # a racing gc got it first

    # -- reads -----------------------------------------------------------
    def load(self, seq: int) -> Dict[str, Any]:
        with open(self._path(seq)) as f:
            doc = json.load(f)
        return doc["state"]

    def latest(self) -> Optional[Tuple[int, Dict[str, Any]]]:
        """(seq, state) of the newest loadable journal; None when the
        directory holds nothing recoverable."""
        for seq in reversed(self.seqs()):
            try:
                return seq, self.load(seq)
            except (OSError, ValueError, KeyError):
                continue                       # torn/corrupt: fall back
        return None
