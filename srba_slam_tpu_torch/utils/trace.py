"""The port's own trace: host spans, program replays and counters, on one
millisecond axis with the card's events.

:func:`record_spans` (also ``ops/cuda_graphs.py`` ``record_spans``) is the
one switch. Inside it the port records, on the thread that entered it:

* the device spans of ``cuda_graphs.span``: the yielded :class:`Trace` is
  the list of their ``(kind, start event, end event)`` triples;
* host spans (:class:`HostSpan`): a name, start and end on
  ``time.perf_counter``, the span open around it (``parent``) and the
  frame index (``est.frame_idx``, given at a frame's root span and taken
  from the parent below it). The sites: ``step``, ``vo``, ``check``,
  ``decision``, ``insertion``, ``window dispatch`` with ``window plan``
  and ``window upload``, ``scan dispatch``, ``batch walk``, ``finalize``,
  each ``Profiler.section`` under its own name, ``capture`` (a program
  captured, its key as ``site``), ``upload`` (``cuda_graphs.upload``, its
  bytes) and ``read`` (a host read, :func:`to_numpy`: its site and bytes,
  its span the time the host was blocked);
* one :class:`Replay` per replay of a ``cuda_graphs.program`` outside
  another program's warm-up or capture: its kind (the key's first
  element), a short name of its key (:func:`key_name`), the host's stamps
  at entry and at return, and the two events of its ``"graph"`` span;
* counters at the same boundaries: ``replays_by_kind``, ``reads`` and
  ``uploads`` (``count``, ``bytes``), and ``window_tables``: the windows
  whose gather tables were built on the device (``device``: a window
  group's valid slots, ``ops/window_ba.py`` ``device_plan``) and on the
  host (``host``: ``assembly_plan``, a window solved alone, and a sharded
  window, ``shard_window_obs``), counted at the call (:func:`tables_built`).

The clock anchor: on entry, on a card, one synchronize, one event and the
host's clock read beside it (:meth:`Trace.host_ms`, :meth:`Trace.device_ms`
place both on one axis). Nothing is synchronized while recording; the
events' times are read once the card is synchronized after the block.

While no trace records, each site makes one test of :data:`ACTIVE` and
returns :data:`NOOP` (or reads as it would): no clock, no event, no
allocation.
"""

from __future__ import annotations

import contextlib
import json
import threading
from dataclasses import dataclass
from time import perf_counter

import torch

# The trace being recorded (record_spans), or None
ACTIVE: Trace | None = None

# The context that every site returns while no trace records
NOOP = contextlib.nullcontext()


@dataclass(slots=True)
class HostSpan:
    id: int                  # its index in ``Trace.host``
    name: str
    t0: float                # host clock, s
    t1: float | None         # None while open
    parent: int | None       # the id of the span open around it
    frame: int | None
    site: str | None = None  # a read's site, a capture's key
    nbytes: int = 0          # a read's or an upload's bytes


@dataclass(slots=True)
class Replay:
    kind: str
    name: str                # key_name(key)
    t0: float                # host clock at entry, s
    t1: float                # host clock at return, s
    start: object            # the "graph" span's events (None where it
    end: object              # recorded none: inside another span, on the CPU)
    parent: int | None       # the innermost host span open at the call
    frame: int | None


def key_name(key) -> str:
    """A short name of a program's key that stays the same from run to run:
    a window group's bucket ``CxLxO`` and its valid slots of all; for other
    kinds the key's kind, numbers, words, flags, dtypes and shapes in order
    (cameras, options and devices left out), at most 80 characters."""
    if not isinstance(key, tuple) or not key:
        return str(key)
    if key[0] == "window_group":
        _kind, c, l, o, valids = key[:5]
        return f"window_group {c}x{l}x{o} {sum(valids)}/{len(valids)}"
    parts = [str(key[0])]
    for x in key[1:]:
        if isinstance(x, (bool, int, float, str)):
            parts.append(str(x))
        elif isinstance(x, torch.dtype):
            parts.append(str(x).removeprefix("torch."))
        elif isinstance(x, tuple) and x and all(type(v) is int for v in x):
            parts.append("x".join(map(str, x)))
    return " ".join(parts)[:80]


class Trace(list):
    """What :func:`record_spans` yields: the list of device spans ``(kind,
    start, end)`` with the host spans, replays and counters beside it."""

    def __init__(self):
        super().__init__()
        self.host: list[HostSpan] = []
        self.replays: list[Replay] = []
        self.replays_by_kind: dict = {}
        self.reads = dict(count=0, bytes=0)
        self.uploads = dict(count=0, bytes=0)
        self.window_tables = dict(device=0, host=0)
        self._open: list[int] = []
        self._thread = threading.get_ident()
        self.anchor = None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            self.anchor = torch.cuda.Event(enable_timing=True)
            self.anchor.record()
        self.t_anchor = perf_counter()

    # ------------------------------------------------------------ the axis
    def host_ms(self, t: float) -> float:
        """A host stamp in ms after the anchor."""
        return (t - self.t_anchor) * 1e3

    def device_ms(self, event) -> float:
        """A recorded event in ms after the anchor (the card synchronized)."""
        return self.anchor.elapsed_time(event)

    # ------------------------------------------------------------ records
    def _begin(self, name: str, frame, site) -> HostSpan:
        parent = self._open[-1] if self._open else None
        if frame is None and parent is not None:
            frame = self.host[parent].frame
        if site is not None and not isinstance(site, str):
            site = key_name(site)
        sp = HostSpan(len(self.host), name, perf_counter(), None, parent, frame, site)
        self.host.append(sp)
        self._open.append(sp.id)
        return sp

    def _end(self, sp: HostSpan):
        sp.t1 = perf_counter()
        self._open.remove(sp.id)
        counter = self.reads if sp.name == "read" else (
            self.uploads if sp.name == "upload" else None)
        if counter is not None:
            counter["count"] += 1
            counter["bytes"] += sp.nbytes

    def _replay(self, t0: float, key, events):
        kind = key[0] if isinstance(key, tuple) and key else str(key)
        parent = self._open[-1] if self._open else None
        start, end = events if events is not None else (None, None)
        self.replays.append(Replay(kind, key_name(key), t0, perf_counter(), start, end, parent,
                                   self.host[parent].frame if parent is not None else None))
        self.replays_by_kind[kind] = self.replays_by_kind.get(kind, 0) + 1

    # ------------------------------------------------------------ export
    def chrome_events(self) -> list[dict]:
        """The record as Chrome trace events (µs on the anchor's axis):
        host spans on process 0, program replays and eager groups on the
        card on process 1 (their events read: synchronize first)."""
        out = [dict(name="process_name", ph="M", pid=0, args=dict(name="host")),
               dict(name="process_name", ph="M", pid=1, args=dict(name="device"))]
        for s in self.host:
            if s.t1 is None:
                continue
            args = dict(frame=s.frame)
            if s.site is not None:
                args["site"] = s.site
            if s.nbytes:
                args["bytes"] = s.nbytes
            out.append(dict(name=s.name, ph="X", pid=0, tid=0, ts=self.host_ms(s.t0) * 1e3,
                            dur=(s.t1 - s.t0) * 1e6, args=args))
        if self.anchor is not None:
            spans = [(r.name, r.kind, r.start, r.end, r.frame) for r in self.replays
                     if r.start is not None]
            spans += [("eager", "eager", a, b, None) for k, a, b in self if k == "eager"]
            for name, cat, a, b, frame in spans:
                ta, tb = self.device_ms(a), self.device_ms(b)
                out.append(dict(name=name, cat=cat, ph="X", pid=1, tid=0, ts=ta * 1e3,
                                dur=(tb - ta) * 1e3, args=dict(frame=frame)))
        return out

    def write_chrome(self, path: str):
        """:meth:`chrome_events` as a JSON trace file (chrome://tracing,
        Perfetto), with the counters under ``otherData``."""
        with open(path, "w") as f:
            json.dump(dict(traceEvents=self.chrome_events(), displayTimeUnit="ms",
                           otherData=dict(replays_by_kind=self.replays_by_kind,
                                          reads=self.reads, uploads=self.uploads,
                                          window_tables=self.window_tables)), f)


@contextlib.contextmanager
def record_spans():
    """Record a :class:`Trace` within the block, and yield it."""
    global ACTIVE
    prev = ACTIVE
    ACTIVE = tr = Trace()
    try:
        yield tr
    finally:
        ACTIVE = prev


class _Span:
    __slots__ = ("tr", "name", "frame", "site", "sp")

    def __init__(self, tr: Trace, name: str, frame, site):
        self.tr, self.name, self.frame, self.site = tr, name, frame, site

    def __enter__(self) -> HostSpan:
        self.sp = self.tr._begin(self.name, self.frame, self.site)
        return self.sp

    def __exit__(self, *exc):
        self.tr._end(self.sp)
        return False


def span(name: str, frame: int | None = None, site=None):
    """A host span around the block (it yields the :class:`HostSpan`, whose
    ``nbytes`` the block may set); :data:`NOOP` while no trace records.
    ``site``: a string, or a program's key (named by :func:`key_name`)."""
    tr = ACTIVE
    if tr is None or tr._thread != threading.get_ident():
        return NOOP
    return _Span(tr, name, frame, site)


def to_numpy(site: str, t: torch.Tensor):
    """``t.cpu().numpy()``, as a ``read`` span of ``site`` and its bytes
    while a trace records."""
    if ACTIVE is None:
        return t.cpu().numpy()
    with span("read", site=site) as sp:
        out = t.cpu().numpy()
        if sp is not None:
            sp.nbytes = out.nbytes
    return out


def tables_built(where: str, n: int = 1):
    """Count ``n`` windows whose gather tables were built ``where``
    (``"device"`` or ``"host"``) while a trace records on this thread."""
    tr = ACTIVE
    if tr is not None and tr._thread == threading.get_ident():
        tr.window_tables[where] += n


def stamp() -> float | None:
    """The host clock while a trace records on this thread, else None: a
    program call's entry (:func:`replay`)."""
    tr = ACTIVE
    if tr is None or tr._thread != threading.get_ident():
        return None
    return perf_counter()


def replay(t0: float, key, events):
    """Record a program call that replayed, from its entry stamp ``t0``
    (:func:`stamp`) to now, with its ``"graph"`` span's events (or None)."""
    ACTIVE._replay(t0, key, events)
