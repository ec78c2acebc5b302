"""Priority / earliest-deadline-first request queues for the engines.

The port's copy of ``repro/workload/queueing.py``.

``ServeEngine`` used to drain its backlog FIFO; with QoS classes the
admission order IS the intra-engine scheduling policy, so the queue
orders by

    (higher priority, earlier absolute deadline, FIFO arrival seq)

i.e. strict priority between classes and EDF inside a class.  Requests
without a QoS class all share priority 1.0 and no deadline, so a
QoS-free workload degrades to the exact FIFO order the pre-QoS engine
had (the tie-break sequence number preserves admission order).

The container mimics the small slice of the ``collections.deque`` API
the engine uses (``append`` / ``popleft`` / ``[0]`` peek / iteration /
``clear``), so it is a drop-in replacement.
"""
from __future__ import annotations

import heapq
import math
from typing import Iterator, List, Tuple


class EDFQueue:
    """Priority + EDF ordered queue of ``Request`` objects."""

    def __init__(self):
        self._heap: List[Tuple[float, float, int, object]] = []
        self._seq = 0

    @staticmethod
    def _key(req) -> Tuple[float, float]:
        qos = getattr(req, "qos", None)
        prio = float(getattr(qos, "priority", 1.0) or 1.0)
        deadline = getattr(req, "deadline_s", None)
        if deadline is None:
            deadline = math.inf
        return (-prio, float(deadline))

    def append(self, req) -> None:
        prio, deadline = self._key(req)
        heapq.heappush(self._heap, (prio, deadline, self._seq, req))
        self._seq += 1

    def popleft(self):
        if not self._heap:
            raise IndexError("pop from an empty EDFQueue")
        return heapq.heappop(self._heap)[-1]

    def __getitem__(self, i: int):
        if i != 0:
            raise IndexError("EDFQueue only exposes the head ([0])")
        return self._heap[0][-1]

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def __iter__(self) -> Iterator:
        """Iterate queued requests (heap order, NOT pop order) — for
        aggregate backlog signals like ``pending_tokens``."""
        return (entry[-1] for entry in self._heap)

    def drain(self, pred) -> List[object]:
        """Remove and return every queued request matching ``pred``.

        The watchdog's shedding hook: surviving entries keep their
        original (priority, deadline, seq) keys, so relative order —
        including FIFO ties — is preserved exactly.
        """
        kept, out = [], []
        for entry in self._heap:
            (out if pred(entry[-1]) else kept).append(entry)
        if out:
            heapq.heapify(kept)
            self._heap = kept
        return [entry[-1] for entry in out]

    def clear(self) -> None:
        self._heap.clear()
        self._seq = 0
