"""Order-preserving wait queue with O(1) membership, removal and
front-insertion.

``Simulator.queue`` used to be a plain ``list`` of job ids: ``remove`` in
``allocate`` and ``insert(0, ...)`` in ``deallocate`` are both O(n), so
large traces with heavy churn (every EaCO undo re-queues at the front, and
every allocation removes from an arbitrary position) went quadratic.  This
class keeps the exact list semantics the schedulers rely on — iteration
order, ``queue[0]`` peeking, ``in``, ``remove``, ``insert(0, ...)`` — on an
insertion-ordered dict, making every hot operation O(1).
"""

from __future__ import annotations

import itertools
from collections import OrderedDict
from typing import Iterable, Iterator


class OrderedQueue:
    """List-semantics wait queue with O(1) append / remove / front-insert
    (see the module docstring for why the plain list went quadratic)."""

    __slots__ = ("_od",)

    def __init__(self, items: Iterable[int] = ()):
        self._od: "OrderedDict[int, None]" = OrderedDict((i, None) for i in items)

    # -- list-compatible surface (what schedulers actually call) -----------

    def append(self, jid: int) -> None:
        """Enqueue ``jid`` at the back (errors if already queued)."""
        if jid in self._od:
            raise ValueError(f"job {jid} already queued")
        self._od[jid] = None

    def appendleft(self, jid: int) -> None:
        """Enqueue ``jid`` at the front (errors if already queued)."""
        if jid in self._od:
            raise ValueError(f"job {jid} already queued")
        self._od[jid] = None
        self._od.move_to_end(jid, last=False)

    def insert(self, index: int, jid: int) -> None:
        """Only front-insertion is supported (the simulator's sole use)."""
        if index != 0:
            raise NotImplementedError("OrderedQueue.insert supports index 0 only")
        self.appendleft(jid)

    def remove(self, jid: int) -> None:
        """Drop ``jid`` from anywhere in the queue (ValueError if absent)."""
        try:
            del self._od[jid]
        except KeyError:
            raise ValueError(f"job {jid} not in queue") from None

    def popleft(self) -> int:
        """Dequeue and return the head job id."""
        jid, _ = self._od.popitem(last=False)
        return jid

    def first_n(self, n: int) -> list:
        """The first ``n`` queued ids as a list (every id when ``n <= 0``)
        — O(n), unlike ``list(queue)[:n]`` which materializes the whole
        backlog before slicing."""
        if n <= 0:
            return list(self._od)
        return list(itertools.islice(self._od, n))

    def __contains__(self, jid: int) -> bool:
        return jid in self._od

    def __len__(self) -> int:
        return len(self._od)

    def __bool__(self) -> bool:
        return bool(self._od)

    def __iter__(self) -> Iterator[int]:
        return iter(self._od)

    def __getitem__(self, index: int) -> int:
        n = len(self._od)
        if index < 0:
            index += n
        if not 0 <= index < n:
            raise IndexError(index)
        if index == 0:  # the hot path: head-of-queue peek
            return next(iter(self._od))
        return next(itertools.islice(self._od, index, None))

    def __eq__(self, other) -> bool:
        if isinstance(other, OrderedQueue):
            return list(self._od) == list(other._od)
        if isinstance(other, list):
            return list(self._od) == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"OrderedQueue({list(self._od)!r})"
