"""Spans inside the port's serving path.

One tracer per process, off by default.  The serving path opens a span
at each layer boundary (``cluster.step``, the scheduler's decision, the
engine's dispatch with its admission, prefill chunks and decode round,
and collect with its blocking copy)::

    with tracing.span("engine.admission", engine=0, lanes=32) as sp:
        ...                                   # the work
    if sp is not None:                        # on: attributes known late
        sp.set(held=n)

**Off** (the default) ``span`` tests one module flag and returns a shared
null context whose ``__enter__`` gives ``None``.  No clock is read, no
span is made and nothing is kept, so a boundary costs a function call
and the evaluation of its arguments.  Work done only for the tracer
sits under ``if sp is not None``; code that does not hold the span (a
step callable inside the engine's) sets attributes on the innermost open
one with :func:`note`.

**On** (:func:`enable`) each span reads ``time.monotonic_ns()`` at its
start and end: the clock of ``time.monotonic``, which ``ServeEngine``,
``EdgeCluster`` and ``Request``'s timestamps use, so all of them compare
directly.  Parents come from a stack of open spans; finished spans are
kept in a list in memory and written nowhere.  :func:`drain` returns
them and empties the list.

While a ``torch.profiler`` records, each span on also opens
``torch.profiler.record_function("rt:<name>")``, so the spans sit in the
profiler's own timeline beside the device's kernels.

The tracer is not thread-safe: the serving path runs on one thread.
"""
from __future__ import annotations

import itertools
import time
from typing import Dict, List

import torch

PREFIX = "rt:"

_on = False
_spans: List[Dict] = []
_stack: List["_Span"] = []
_ids = itertools.count(1)


class _Null:
    """The off path's shared context: no clock, no record."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "start_ns", "_range")

    def __init__(self, name: str, attrs: Dict):
        self.name = name
        self.attrs = attrs
        self._range = None

    def set(self, **attrs) -> None:
        """Attributes known only at the end of the span."""
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        self.id = next(_ids)
        self.parent = _stack[-1].id if _stack else None
        _stack.append(self)
        if torch._C._autograd._profiler_enabled():
            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        self.start_ns = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end_ns = time.monotonic_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _stack.pop()
        _spans.append({"id": self.id, "parent": self.parent,
                       "name": self.name, "start_ns": self.start_ns,
                       "end_ns": end_ns, "attrs": self.attrs})
        return False


def span(name: str, **attrs):
    """A span named ``name`` with ``attrs``; the null context when off."""
    if not _on:
        return _NULL
    return _Span(name, attrs)


def note(**attrs) -> None:
    """Attributes of the innermost open span, set from code that does
    not hold it (a step callable inside the engine's span); nothing when
    off or when no span is open."""
    if _on and _stack:
        _stack[-1].attrs.update(attrs)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def drain() -> List[Dict]:
    """The finished spans, emptied here: each ``{"id", "parent", "name",
    "start_ns", "end_ns", "attrs"}`` with ``parent`` the id of the span
    open around it (None at the top) and its times in
    ``time.monotonic_ns()``; spans still open stay out."""
    out = list(_spans)
    _spans.clear()
    return out
