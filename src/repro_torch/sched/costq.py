"""A blocked sorted store for cost-ordered scheduling queues.

The paper's premise is queues of "thousands or even millions of similar
tasks"; the cost-ordered policies (`sjf`/`lpt`/`pack`) previously kept a
binary heap, which is O(log n) for pop-min but gave `PackingPolicy` no
way to answer its budget-fit query ("the longest task that still fits
this worker's remaining allocation") without sorting the whole heap on
EVERY pop — O(n log n) per decision, O(n^2 log n) to drain a queue.

`SortedCostQueue` keeps entries `(key, tick, item)` fully sorted at all
times in bisect-indexed blocks (the sortedcontainers layout, implemented
here because the container ships no such dependency): a flat list of
bounded sorted blocks plus a parallel list of per-block maxima.  Every
operation bisects the maxima to find the owning block, then bisects
inside it — O(log n) comparisons with memmoves bounded by the block size,
so a 1M-entry queue pays the same per-decision overhead as a 1k-entry
one:

  * ``insert``            — push one entry;
  * ``pop_first``         — global minimum (the heap-pop equivalent);
  * ``pop_last``          — global maximum (pack's nothing-fits fallback:
                            under sign=-1 keys that is the SHORTEST task,
                            latest arrival among ties — exactly what the
                            old ``sorted(heap)[-1]`` returned);
  * ``pop_first_at_least``— first entry in sort order with key >= bound
                            (pack's budget fit: keys are -cost, so the
                            bound -budget selects the LONGEST task that
                            fits, earliest arrival among ties);
  * ``rebuild``           — replace all keys at once (the predictor
                            learned something): one O(n log n) sort into
                            freshly balanced blocks, amortised across the
                            whole queue instead of paid per pop.

Entries are ordered by ``(key, tick)``; ticks come from the policies'
arrival counter and are unique, so the payload item is never compared.
Deletion is eager (a bounded ``del block[i]``, cheaper at realistic block
sizes than tombstone bookkeeping) and empty blocks are dropped so the
maxima index never goes stale.
"""
from __future__ import annotations

from bisect import bisect_left, insort
from typing import Any, Iterable, List, Optional, Tuple

Entry = Tuple[float, int, Any]                 # (key, tick, item)

# Blocks split at 2*LOAD and are rebuilt at LOAD: keeps every memmove
# bounded while the maxima index stays tiny (n / LOAD entries).
LOAD = 1024


class SortedCostQueue:
    """Sorted multiset of ``(key, tick, item)`` with O(log n) ends and
    bounded-key queries (see module docstring for the operation set)."""

    __slots__ = ("_blocks", "_maxes", "_len")

    def __init__(self, entries: Optional[Iterable[Entry]] = None):
        self._blocks: List[List[Entry]] = []
        self._maxes: List[Entry] = []          # last entry of each block
        self._len = 0
        if entries is not None:
            self.rebuild(list(entries))

    # -- bulk -----------------------------------------------------------
    def rebuild(self, entries: List[Entry]) -> None:
        """Replace the contents with `entries` (keys may have changed):
        one sort, then slice into balanced blocks."""
        entries = sorted(entries, key=lambda e: (e[0], e[1]))
        self._blocks = [entries[i:i + LOAD]
                        for i in range(0, len(entries), LOAD)]
        self._maxes = [b[-1] for b in self._blocks]
        self._len = len(entries)

    def clear(self) -> None:
        self._blocks, self._maxes, self._len = [], [], 0

    # -- inserts --------------------------------------------------------
    def insert(self, key: float, tick: int, item: Any) -> None:
        entry = (key, tick, item)
        if not self._blocks:
            self._blocks.append([entry])
            self._maxes.append(entry)
            self._len = 1
            return
        # owning block: the first whose max sorts >= entry (the last
        # block takes everything beyond the current maximum)
        b = min(bisect_left(self._maxes, entry), len(self._blocks) - 1)
        block = self._blocks[b]
        insort(block, entry)
        self._maxes[b] = block[-1]
        self._len += 1
        if len(block) > 2 * LOAD:              # split, keep both bounded
            half = len(block) // 2
            self._blocks[b:b + 1] = [block[:half], block[half:]]
            self._maxes[b:b + 1] = [self._blocks[b][-1],
                                    self._blocks[b + 1][-1]]

    # -- removals -------------------------------------------------------
    def _delete(self, b: int, i: int) -> Entry:
        block = self._blocks[b]
        entry = block[i]
        del block[i]
        if block:
            self._maxes[b] = block[-1]
        else:
            del self._blocks[b]
            del self._maxes[b]
        self._len -= 1
        return entry

    def pop_first(self) -> Optional[Entry]:
        if not self._len:
            return None
        return self._delete(0, 0)

    def pop_last(self) -> Optional[Entry]:
        if not self._len:
            return None
        return self._delete(len(self._blocks) - 1, -1)

    def pop_first_at_least(self, key_bound: float) -> Optional[Entry]:
        """Remove and return the first entry (in sort order) whose key is
        >= `key_bound`; None if every key is below the bound."""
        if not self._len:
            return None
        probe = (key_bound,)                   # sorts before any real
        b = bisect_left(self._maxes, probe)    # (key_bound, tick) entry
        if b == len(self._blocks):
            return None
        # this block's max is >= probe, so the in-block bisect always
        # lands on a valid entry
        return self._delete(b, bisect_left(self._blocks[b], probe))

    # -- views ----------------------------------------------------------
    def __len__(self) -> int:
        return self._len

    def __iter__(self):
        for block in self._blocks:
            yield from block

    def entries(self) -> List[Entry]:
        """All entries in sort order (pending-snapshot support)."""
        out: List[Entry] = []
        for block in self._blocks:
            out.extend(block)
        return out
