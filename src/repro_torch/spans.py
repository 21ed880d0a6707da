"""Host spans of the serving path, recorded in memory while
:func:`record` is open.

A span is a named interval of ``time.perf_counter_ns`` (the host clock
that a device trace is tied to by marker kernels, so spans and the
trace's timeline share one clock), with its parent span, the request
it served and, where it moves data, a byte count::

    with spans.record() as rec:
        ...                       # serve
    for s in rec.spans: ...

    # in the program
    with spans.span("tier.emit") as sp:
        out = emit(...)
        if sp:
            sp.nbytes = sum(map(len, out))

Recording is off unless :func:`record` is open; off, :func:`span`
returns one shared no-op context (false, and deaf to ``nbytes``) and
allocates nothing.  A span never synchronises the device: around a
launch it times the enqueue, and the device trace gives the device side.
Spans of one name never nest: while one is open, a span of the same name
opened inside it records nothing, so a recursive caller is timed once,
outermost.  A span opened with ``request=`` names the request of every
span opened inside it.  While recording, each pass of the interpreter's
cyclic garbage collector is a span too, ``gc``, wherever it falls: the
host stalls there as in any phase.

Counters ride along: :func:`count` adds a whole number to the
recorder's ``counters`` by name while recording (the serving engine's
MoE pair counts, read once a request at its retire).

The recorder in use is module state rather than an argument: the spans
sit deep in the tier and the codec, on call paths that carry no context.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, Iterator, List, Optional, Set

now = time.perf_counter_ns


class Span:
    """One recorded span: ``start`` / ``end`` in ``perf_counter_ns``
    (``end`` 0 while open), ``parent`` the index of the enclosing span in
    :attr:`Recorder.spans` (-1 at the top), ``request`` the request id of
    the engine call it ran under (None outside one), ``nbytes`` the bytes
    it moved (None where it moves none)."""

    __slots__ = ("name", "start", "end", "parent", "request", "nbytes",
                 "_rec", "_outer_request")

    def __init__(self, rec: "Recorder", name: str, nbytes: Optional[int],
                 request: Optional[str]):
        self._rec = rec
        self.name = name
        self.nbytes = nbytes
        self.request = request
        self.start = self.end = 0
        self.parent = -1

    def __enter__(self) -> "Span":
        rec = self._rec
        self._outer_request = rec.request
        if self.request is None:
            self.request = rec.request
        else:
            rec.request = self.request
        self.parent = rec._stack[-1] if rec._stack else -1
        rec._stack.append(len(rec.spans))
        rec.spans.append(self)
        rec._open.add(self.name)
        self.start = now()
        return self

    def __exit__(self, *exc) -> None:
        self.end = now()
        rec, self._rec = self._rec, None
        rec._stack.pop()
        rec._open.discard(self.name)
        rec.request = self._outer_request

    @property
    def ns(self) -> int:
        return self.end - self.start

    def __repr__(self):
        return (f"Span({self.name!r}, {self.ns} ns, parent={self.parent}, "
                f"request={self.request!r}, nbytes={self.nbytes})")


class _Off:
    """The one context :func:`span` returns while nothing records."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def __bool__(self) -> bool:
        return False

    @property
    def nbytes(self) -> None:
        return None

    @nbytes.setter
    def nbytes(self, value) -> None:
        pass


OFF = _Off()


class Recorder:
    """The spans of one :func:`record` block, in the order they opened."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self.request: Optional[str] = None
        self._stack: List[int] = []
        self._open: Set[str] = set()
        self._gc: Optional[Span] = None

    def _on_gc(self, phase: str, info: dict):
        """``gc.callbacks`` entry: a collection is a ``gc`` span."""
        if phase == "start":
            self._gc = Span(self, "gc", None, None).__enter__()
        elif self._gc is not None:
            self._gc.__exit__()
            self._gc = None


_active: Optional[Recorder] = None


def span(name: str, nbytes: Optional[int] = None,
         request: Optional[str] = None):
    """A context that records one span while :func:`record` is open (see
    the module's docstring); :data:`OFF` otherwise, or while a span of
    the same name is open."""
    rec = _active
    if rec is None or name in rec._open:
        return OFF
    return Span(rec, name, nbytes, request)


def recording() -> bool:
    """Whether :func:`record` is open."""
    return _active is not None


def count(name: str, n: int) -> None:
    """Add ``n`` to the recorder's counter ``name``; nothing while off."""
    rec = _active
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + int(n)


@contextlib.contextmanager
def record() -> Iterator[Recorder]:
    """Record every span opened inside the block into a new
    :class:`Recorder`; recording stops when the block ends."""
    global _active
    if _active is not None:
        raise RuntimeError("spans are already being recorded")
    rec = _active = Recorder()
    gc.callbacks.append(rec._on_gc)
    try:
        yield rec
    finally:
        gc.callbacks.remove(rec._on_gc)
        _active = None
