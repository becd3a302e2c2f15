"""The span tree behind ``utils/timing.py``: every span with its start, end,
parent and labeling cycle, kept in a fixed ring of the last
``RING_CYCLES`` cycles and fed to three families of ``obs/metrics.py``.

A span is one tuple ``(id, parent, cycle, name, start_ns, end_ns, pid,
tid)``, stamped on CLOCK_MONOTONIC (``time.monotonic_ns``), the one clock
the daemon and its broker worker share on a node. Ids are unique on the
node: the process id in the high bits, a counter in the low ones, so a
worker's spans fold into the labeling process's ring unchanged. Cycle 0
holds what runs outside any cycle (an epoch's start, a worker's start).

Each thread has a current ``(cycle, parent)``: a span's parent is the
span open on its thread when it started. Threads do not inherit it (a
pool drops context), so the engine, the probe threads and the worker's
request loop hand it on with ``adopt``.

The ring is ``RING_CYCLES`` slots of ``RING_SPANS`` spans, allocated once;
a cycle's spans go to the slot its id names, and a span past a slot's
room is counted as dropped. Every span is observed once in
``tfd_span_duration_seconds{span}``: a cycle's spans when it closes.

The labeling process closes a cycle when the next begins (or the epoch
ends) and splits the time between two consecutive probes' device windows
(``probe.device``) into ``tfd_probe_gap_seconds{layer}``: ``probe`` (the
health labeler's time outside the broker's pipe, the worker's receipt to
the probe's first launch, its report and reply), ``broker``
(``broker.rpc.health`` less ``worker.health``: the pipe both ways),
``labelgen`` (``labelgen.total`` outside the health labeler) and ``loop``
(``cycle`` outside ``labelgen.total``). The four parts sum to the gap
exactly: each is a difference of nested covers of the same interval.
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from gpu_feature_discovery_tpu_torch.obs import metrics

RING_CYCLES = 64
RING_SPANS = 128

# The layers of tfd_probe_gap_seconds, and the spans that bound them.
GAP_LAYERS = ("probe", "broker", "labelgen", "loop")
_GAP_SPANS = {"labelgen.total": 0, "labeler.health": 1, "broker.rpc.health": 2,
              "worker.health": 3, "probe.device": 4}

# Injected by tests: every stamp comes from here.
now_ns = time.monotonic_ns

Span = Tuple[int, int, int, str, int, int, int, int]


class _Context(threading.local):
    # (cycle, parent): one attribute, read and replaced whole.
    now = (0, 0)
    tid = 0  # the thread's native id, read once


_ctx = _Context()
_lock = threading.Lock()
_pid = os.getpid()
_ids = itertools.count(1)
# [cycle, count, slots] per ring slot.
_ring: List[list] = [[-1, 0, [None] * RING_SPANS] for _ in range(RING_CYCLES)]
_dropped = 0
_open_cycle: Optional[Tuple[int, int, int]] = None  # (cycle, span id, start)
_last_cycle = 0
_outbox: Optional[List[Span]] = None
_outbox_dropped = 0
OUTBOX_LIMIT = 4 * RING_SPANS
# pid -> (monotonic-to-profiler offset ns, source), from folded workers.
_peer_offsets: Dict[int, Tuple[int, str]] = {}


class _Gaps:
    """The gap in progress between two probes: where it started (the last
    device window's end) and its parts so far, in ns."""

    def __init__(self):
        self.start: Optional[int] = None
        self.parts = [0, 0, 0, 0]

    def reset(self) -> None:
        self.start = None
        self.parts = [0, 0, 0, 0]


_gaps = _Gaps()


def new_id() -> int:
    return (_pid << 32) | next(_ids)


def context() -> Tuple[int, int]:
    """The calling thread's ``(cycle, parent)``, to hand to another thread."""
    return _ctx.now


def set_context(ctx: Tuple[int, int]) -> Tuple[int, int]:
    """Set the calling thread's ``(cycle, parent)``; returns the one it
    replaces."""
    old = _ctx.now
    _ctx.now = ctx
    return old


def record(name: str, start: int, end: int, span_id: int, parent: int,
           cycle: int, pid: Optional[int] = None, tid: Optional[int] = None) -> None:
    """File one finished span in the ring (and the worker's outbox). Its
    duration is observed when its cycle closes, in one pass over the
    cycle's slot; a span of no open cycle is observed at once, except in
    the broker worker, whose spans are observed where they are folded."""
    global _dropped, _outbox_dropped
    if tid is None:
        tid = _ctx.tid or _own_tid()
    span = (span_id, parent, cycle, name, start, end, pid or _pid, tid)
    observe = True
    with _lock:
        slot = _ring[cycle % RING_CYCLES]
        if slot[0] != cycle:
            if cycle > slot[0]:
                slot[0], slot[1] = cycle, 0
            else:
                slot = None
        if slot is not None and slot[1] < RING_SPANS:
            slot[2][slot[1]] = span
            slot[1] += 1
            observe = _open_cycle is None or cycle != _open_cycle[0]
        else:
            _dropped += 1
        if _outbox is not None:
            observe = False
            if len(_outbox) < OUTBOX_LIMIT:
                _outbox.append(span)
            else:
                _outbox_dropped += 1
        if name == "probe.device" and _open_cycle is not None and cycle != _open_cycle[0]:
            # A device window filed under a cycle already closed (a probe
            # that outlived its labeler's deadline): the gap it would end
            # was counted without it, so none spans it.
            _gaps.reset()
    if observe:
        _child(metrics.SPAN_DURATION, name).observe((end - start) / 1e9)


def _own_tid() -> int:
    _ctx.tid = threading.get_native_id()
    return _ctx.tid


# (family, label value) -> the histogram's child, so a span's end skips
# the label lookup. ``reset`` clears it with the registry's children.
_children: Dict[Tuple[str, str], object] = {}


def _child(family, value: str):
    child = _children.get((family.name, value))
    if child is None:
        child = _children[(family.name, value)] = family.labels(
            **{family.labelnames[0]: value})
    return child


# -- cycles (the labeling process) ------------------------------------------

def begin_cycle() -> int:
    """Close the open cycle (its end is this one's start) and open the
    next, as the calling thread's root. Returns the new cycle's id."""
    global _open_cycle, _last_cycle
    t = now_ns()
    closing = _open_cycle
    if closing is not None:
        _close(closing, t)
    cycle = _last_cycle = _last_cycle + 1
    span_id = new_id()
    _open_cycle = (cycle, span_id, t)
    set_context((cycle, span_id))
    return cycle


def end_cycle() -> None:
    """Close the open cycle (an epoch's end); the next cycle starts a new
    chain, so no gap spans the two."""
    global _open_cycle
    closing = _open_cycle
    if closing is not None:
        _close(closing, now_ns())
    _open_cycle = None
    _gaps.reset()
    set_context((0, 0))


def _close(open_cycle: Tuple[int, int, int], end: int) -> None:
    cycle, span_id, start = open_cycle
    record("cycle", start, end, span_id, 0, cycle)
    with _lock:
        slot = _ring[cycle % RING_CYCLES]
        ended = [slot[2][i] for i in range(slot[1])] if slot[0] == cycle else []
    family = metrics.SPAN_DURATION
    family.observe_children([(_child(family, s[3]), (s[5] - s[4]) / 1e9) for s in ended])
    family = metrics.PROBE_GAP
    for parts in _account_gaps(cycle, start, end):
        family.observe_children([(_child(family, layer), ns / 1e9)
                                 for layer, ns in zip(GAP_LAYERS, parts)])


def _cover(intervals: List[Tuple[int, int]], a: int, b: int) -> int:
    """How much of ``[a, b]`` the union of ``intervals`` covers, in ns."""
    total = 0
    reach = a
    for s, e in sorted(intervals):
        s, e = max(s, reach), min(e, b)
        if e > s:
            total += e - s
            reach = e
    return total


def _split(spans: List[List[Tuple[int, int]]], a: int, b: int) -> List[int]:
    """``[a, b]`` of one cycle split into the gap's layers, nested covers
    clamped so that every part is at least 0 and the parts sum to
    ``b - a``."""
    g = _cover(spans[0], a, b)
    h = min(_cover(spans[1], a, b), g)
    r = min(_cover(spans[2], a, b), h)
    w = min(_cover(spans[3], a, b), r)
    return [h - (r - w), r - w, g - h, (b - a) - g]


def _account_gaps(cycle: int, start: int, end: int) -> List[List[int]]:
    """Fold a closed cycle into the gap in progress; the gaps it ended."""
    with _lock:
        slot = _ring[cycle % RING_CYCLES]
        spans: List[List[Tuple[int, int]]] = [[], [], [], [], []]
        if slot[0] == cycle:
            for i in range(slot[1]):
                span = slot[2][i]
                kind = _GAP_SPANS.get(span[3])
                if kind is not None:
                    spans[kind].append((span[4], span[5]))
        observed = []
        for d0, d1 in sorted(spans[4]):
            a = start if _gaps.start is None else max(_gaps.start, start)
            if _gaps.start is not None and a <= d0:
                part = _split(spans, a, d0)
                observed.append([x + y for x, y in zip(_gaps.parts, part)])
            _gaps.reset()
            _gaps.start = d1
        if _gaps.start is not None:
            a = max(_gaps.start, start)
            if a < end:
                _gaps.parts = [x + y for x, y in zip(_gaps.parts, _split(spans, a, end))]
        return observed


# -- the broker worker's outbox ----------------------------------------------

def ship() -> None:
    """Keep every span this process ends for ``drain`` (the worker)."""
    global _outbox
    with _lock:
        if _outbox is None:
            _outbox = []


def drain() -> List[list]:
    """The spans ended since the last drain, as JSON lists."""
    global _outbox
    with _lock:
        if not _outbox:
            return []
        out, _outbox = _outbox, []
    return [list(s) for s in out]


def fold(spans, parent: int, cycle: int, pid: Optional[int] = None,
         offset: Optional[Tuple[int, str]] = None) -> None:
    """File a worker's spans in this process's ring: a span of cycle 0
    (the worker's start) under ``cycle``, a root under ``parent`` (the
    RPC that carried it)."""
    try:
        _peer_offsets[int(pid)] = (int(offset[0]), str(offset[1]))
    except (TypeError, ValueError, IndexError):
        pass
    for s in spans or ():
        try:
            sid, sparent, scycle, name, start, end, spid, stid = s
            record(str(name), int(start), int(end), int(sid), int(sparent) or parent,
                   int(scycle) or cycle, int(spid), int(stid))
        except (TypeError, ValueError):
            continue


# -- export -------------------------------------------------------------------

_offset_cache: List = [None, 0]  # (offset, source), when measured (ns)
OFFSET_TTL_NS = 10 * 10**9


def cached_profiler_offset() -> Tuple[int, str]:
    """``profiler_offset`` measured at most every ``OFFSET_TTL_NS``."""
    t = time.monotonic_ns()
    if _offset_cache[0] is None or t - _offset_cache[1] > OFFSET_TTL_NS:
        _offset_cache[0], _offset_cache[1] = profiler_offset(), t
    return _offset_cache[0]


def profiler_offset() -> Tuple[int, str]:
    """The offset, in ns, from CLOCK_MONOTONIC to the clock torch.profiler
    stamps operations with (Unix time, from an approximate clock that it
    calibrates to CLOCK_REALTIME): read from the profiler's own clock
    where this process holds a torch that exposes it, else from
    CLOCK_REALTIME (torch 2.11 exposes none; tests/test_torch_cuda.py
    holds a profiled probe's CUDA operations inside its ``probe.device``
    span with it). The pair of reads that lies closest together of 16
    gives it."""
    torch = sys.modules.get("torch")
    read = time.time_ns
    source = "CLOCK_REALTIME"
    try:
        prof = torch._C._profiler  # type: ignore[union-attr]
        converter = prof._ApproximateClockToUnixTimeConverter()
        approx = prof._get_approximate_time
        read = lambda: converter.to_unix_ns(approx())  # noqa: E731
        source = "torch.profiler"
    except AttributeError:
        pass
    best = None
    for _ in range(16):
        a = time.monotonic_ns()
        t = read()
        b = time.monotonic_ns()
        if best is None or b - a < best[0]:
            best = (b - a, t - (a + b) // 2)
    return best[1], source


def snapshot() -> List[Span]:
    """Every span in the ring, oldest cycle first."""
    with _lock:
        slots = sorted((s for s in _ring if s[0] >= 0), key=lambda s: s[0])
        return [s[2][i] for s in slots for i in range(s[1])]


def chrome_trace(base_ns: int = 0) -> dict:
    """The ring as Chrome trace-event JSON (Perfetto loads it): one
    complete event per span, ``ts`` and ``dur`` in µs on torch.profiler's
    clock (each process's measured offset applied) less ``base_ns`` (a
    profiler export's ``baseTimeNanoseconds``, so that both files share
    an origin), the cycle, id and parent in ``args``."""
    own = profiler_offset()
    offsets = dict(_peer_offsets)
    offsets[_pid] = own
    spans = snapshot()
    events = []
    for pid in sorted({s[6] for s in spans} | {_pid}):
        role = "labeling process" if pid == _pid else "broker worker"
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "args": {"name": f"tfd {role} {pid}"}})
    for sid, parent, cycle, name, start, end, pid, tid in spans:
        offset = offsets.get(pid, own)[0]
        events.append({
            "name": name, "cat": "tfd", "ph": "X", "pid": pid, "tid": tid,
            "ts": (start + offset - base_ns) / 1e3, "dur": (end - start) / 1e3,
            "args": {"cycle": cycle, "id": str(sid), "parent": str(parent)},
        })
    cycles = sorted({s[2] for s in spans})
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "baseTimeNanoseconds": base_ns,
        "otherData": {
            "clock": "torch.profiler (Unix ns); span stamps are CLOCK_MONOTONIC "
                     "plus each process's offset",
            "offsets_ns": {str(pid): {"offset_ns": o, "source": src}
                           for pid, (o, src) in sorted(offsets.items())},
            "cycles": cycles,
            "ring_cycles": RING_CYCLES,
            "dropped": _dropped + _outbox_dropped,
        },
    }


def reset() -> None:
    """Forget every span and the gap in progress (tests)."""
    global _dropped, _outbox_dropped, _last_cycle, _open_cycle
    for slot in _ring:
        slot[0], slot[1] = -1, 0
    _dropped = _outbox_dropped = 0
    _last_cycle = 0
    _open_cycle = None
    _peer_offsets.clear()
    _children.clear()
    _gaps.reset()
    set_context((0, 0))

