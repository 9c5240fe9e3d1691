"""The port's tracing: one in-memory recorder of spans, counters and
served requests, on the profiler's clock, and the ``torch.profiler``
window of ``trace_dir``.

- :func:`span` / :func:`count` record into :data:`RECORDER`, the
  process's recorder.  A span keeps its name, its start and end, the
  span that encloses it on the same thread, up to two ordinals (the
  step, the microbatch, the batch) and whether a profiler was
  recording when it began.  A count is an instant record of an amount,
  inside the span that encloses it.
- Stamps are :func:`time.time_ns`, the clock of kineto's ``start_ns()``,
  so a span lines up with the kernels of a profiler's trace.  While a
  profiler records, a span also enters ``record_function("mca.<name>")``
  and appears in that trace; otherwise it does not (entering one costs
  more than the span).
- Records live in preallocated int64 columns (interned names),
  :data:`CAPACITY` of them, the oldest overwritten first: no Python
  object is kept per record, so the collector has nothing to walk.
- :meth:`Span.device_start` / :meth:`Span.device_end` time a span's
  work on a CUDA device with an event pair, read by :meth:`Recorder.settle`
  only once the end event has completed.  Call it after a point where
  the host already waits for the device: the recorder adds no
  synchronisation.
- :meth:`Recorder.request` / :meth:`~Recorder.dispatched` /
  :meth:`~Recorder.answered` stamp a served request's submission, the
  start of the forward that carries it, and its answer.
- :func:`trace_context`: a ``torch.profiler`` window over a block (the
  JAX package's ``jax.profiler`` trace of the second launch), written as
  a Chrome trace into ``trace_dir``.

The recorder is always on and has no switch; readers take its columns
with :meth:`Recorder.records` and :meth:`Recorder.requests`.
"""

from __future__ import annotations

import collections
import itertools
import logging
import os
import struct
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.autograd.profiler as _profiler

_log = logging.getLogger(__name__)

CAPACITY = 1 << 17
PREFIX = "mca."

# the columns of a span or count record
SEQ, NAME, START, END, PARENT, PROFILED, KEY0, ORD0, KEY1, ORD1, VALUE = range(11)
FIELDS = ("seq", "name", "start", "end", "parent", "profiled", "key0", "ord0", "key1", "ord1",
          "value")
NF = len(FIELDS)
# the columns of a request record
RID, SUBMIT, DISPATCH, ANSWER, BATCH, RPROFILED = range(6)
REQUEST_FIELDS = ("id", "submit", "dispatch", "answer", "batch", "profiled")
NR = len(REQUEST_FIELDS)
_ROW = struct.Struct(f"{NF}q")
_REQUEST = struct.Struct(f"{NR}q")
_NO_ORDINALS = (-1, -1, -1, -1)

_now = time.time_ns
_PENDING_MAX = 4096  # device timings awaiting their end event; older ones are dropped


class _Stack(threading.local):
    def __init__(self):
        self.stack: List[int] = []


class Span:
    """One open span (:meth:`Recorder.span`); a context manager."""

    __slots__ = ("rec", "name", "ordinals", "seq", "_rf", "_start_ev", "_device")

    def __init__(self, rec: "Recorder", name: str, ordinals: Dict[str, int]):
        if len(ordinals) > 2:
            raise ValueError(f"a span takes at most two ordinals, got {sorted(ordinals)}")
        self.rec, self.name, self.ordinals = rec, name, ordinals
        self._rf = self._start_ev = self._device = None

    def __enter__(self) -> "Span":
        rec = self.rec
        profiled = _profiler._is_profiler_enabled
        self.seq = seq = next(rec._next)
        stack = rec._local.stack
        keys = _NO_ORDINALS
        if self.ordinals:
            keys = [-1, -1, -1, -1]
            for k, (key, v) in enumerate(self.ordinals.items()):
                keys[2 * k], keys[2 * k + 1] = rec.intern(key), int(v)
        # one C call writes the whole row, so no reader sees half of it
        name = rec._ids.get(self.name)
        if name is None:
            name = rec.intern(self.name)
        _ROW.pack_into(rec._buf, (seq & rec._mask) * _ROW.size, seq, name,
                       _now(), 0, stack[-1] if stack else -1, profiled, *keys, -1)
        stack.append(seq)
        if profiled:
            self._rf = torch.profiler.record_function(PREFIX + self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._start_ev is not None:
            self.device_end()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        rec = self.rec
        stack = rec._local.stack
        if stack and stack[-1] == self.seq:
            stack.pop()
        i = (self.seq & rec._mask) * NF
        if rec._mv[i + SEQ] == self.seq:  # not yet overwritten
            rec._mv[i + END] = _now()
        return False

    def device_start(self, device) -> None:
        """Record the start event on ``device``'s current stream (a CUDA
        device only; nothing elsewhere)."""
        device = torch.device(device)
        if device.type != "cuda":
            return
        self._device = device.index if device.index is not None else torch.cuda.current_device()
        self._start_ev = self.rec._event(self._device)
        self._start_ev.record(self.rec._stream(self._device))

    def device_end(self) -> None:
        """Record the end event; its elapsed time from the start event
        becomes the record's ``value`` (ns) at the first
        :meth:`Recorder.settle` after it completes."""
        start, self._start_ev = self._start_ev, None
        if start is None:
            return
        end = self.rec._event(self._device)
        end.record(self.rec._stream(self._device))
        self.rec._await(self.seq, start, end, self._device)


class Recorder:
    """Spans, counts and requests of one process (module docstring).

    ``capacity`` (a power of two) bounds each table; the oldest records
    are overwritten first."""

    def __init__(self, capacity: int = CAPACITY):
        if capacity <= 0 or capacity & (capacity - 1):
            raise ValueError(f"capacity must be a power of two, got {capacity}")
        self.capacity = capacity
        self._mask = capacity - 1
        self._rows = np.zeros((capacity, NF), np.int64)
        self._rows[:, SEQ] = -1
        self._buf = memoryview(self._rows).cast("B")
        self._mv = self._buf.cast("q")
        self._reqs = np.zeros((capacity, NR), np.int64)
        self._reqs[:, RID] = -1
        self._rbuf = memoryview(self._reqs).cast("B")
        self._rmv = self._rbuf.cast("q")
        self._next = itertools.count()  # next() is atomic under the GIL
        self._next_request = itertools.count()
        self._ids: Dict[str, int] = {}
        self._names: List[str] = []
        self._intern_lock = threading.Lock()
        self._local = _Stack()
        self._pending: "collections.deque" = collections.deque()
        self._pending_lock = threading.Lock()
        # settled events by device index, reused: an event records on one device only
        self._spare: Dict[int, "collections.deque"] = collections.defaultdict(collections.deque)
        self._streams: Dict[tuple, "torch.cuda.Stream"] = {}

    # -- recording -------------------------------------------------------

    def intern(self, name: str) -> int:
        i = self._ids.get(name)
        if i is None:
            with self._intern_lock:
                i = self._ids.get(name)
                if i is None:
                    i = len(self._names)
                    self._names.append(name)
                    self._ids[name] = i
        return i

    def span(self, name: str, **ordinals: int) -> Span:
        return Span(self, name, ordinals)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name``: an instant record inside the
        span that encloses it on this thread."""
        seq = next(self._next)
        stack = self._local.stack
        t = _now()
        _ROW.pack_into(self._buf, (seq & self._mask) * _ROW.size, seq, self.intern(name), t, t,
                       stack[-1] if stack else -1, _profiler._is_profiler_enabled,
                       -1, -1, -1, -1, int(n))

    def request(self) -> int:
        """Stamp a request's submission; returns its id."""
        rid = next(self._next_request)
        _REQUEST.pack_into(self._rbuf, (rid & self._mask) * _REQUEST.size, rid, _now(), 0, 0, -1,
                           _profiler._is_profiler_enabled)
        return rid

    def dispatched(self, rids: Sequence[int], batch: int) -> None:
        """Stamp the start of the forward (the span ``batch``) that
        carries the requests ``rids``."""
        self._stamp(rids, DISPATCH, batch)

    def answered(self, rids: Sequence[int]) -> None:
        """Stamp the answer of the requests ``rids``, just before their
        results are set."""
        self._stamp(rids, ANSWER)

    def _stamp(self, rids: Sequence[int], col: int, batch: Optional[int] = None) -> None:
        if not len(rids):
            return
        t = _now()
        ids = np.asarray(rids, np.int64)
        i = ids & self._mask
        i = i[self._reqs[i, RID] == ids]  # leave out records overwritten since
        self._reqs[i, col] = t
        if batch is not None:
            self._reqs[i, BATCH] = batch

    def _event(self, device: int):
        try:
            return self._spare[device].pop()
        except IndexError:
            return torch.cuda.Event(enable_timing=True)

    def _stream(self, device: int):
        """The device's current stream on this thread, its Python object
        made once (``torch.cuda.current_stream`` makes one each call)."""
        key = torch._C._cuda_getCurrentStream(device)
        stream = self._streams.get(key)
        if stream is None:
            stream = self._streams[key] = torch.cuda.Stream(
                stream_id=key[0], device_index=key[1], device_type=key[2])
        return stream

    def _await(self, seq: int, start, end, device: Optional[int] = None) -> None:
        with self._pending_lock:
            if len(self._pending) >= _PENDING_MAX:
                self._pending.popleft()
            self._pending.append((seq, start, end, device))

    def settle(self) -> None:
        """Read the device time of every timed span whose end event has
        completed, in the order they ended; never waits for the device."""
        with self._pending_lock:
            while self._pending:
                seq, start, end, device = self._pending[0]
                if not end.query():
                    break
                self._pending.popleft()
                i = (seq & self._mask) * NF
                if self._mv[i + SEQ] == seq:
                    self._mv[i + VALUE] = int(round(start.elapsed_time(end) * 1e6))
                spare = self._spare[device]
                if device is not None and len(spare) < _PENDING_MAX:
                    spare.extend((start, end))

    # -- reading ---------------------------------------------------------

    def mark(self) -> int:
        """The seq the next record will take: ``records(since=mark())``
        reads what was recorded after this call."""
        return int(self._rows[:, SEQ].max()) + 1

    def records(self, name: Optional[str] = None, prefix: Optional[str] = None,
                since: int = 0) -> Dict[str, np.ndarray]:
        """The records held (named ``name``, or starting with ``prefix``;
        seq at least ``since``; spans that have ended), in the order they
        began, as columns: ``seq``, ``name`` (strings),
        ``start``, ``end``, ``parent`` (the enclosing span's seq, -1
        none), ``profiled``, ``value`` (a count's amount; a span's
        device ns, -1 where not timed) and one column per ordinal key
        (-1 where a record lacks it)."""
        rows = self._rows.copy()
        keep = (rows[:, SEQ] >= since) & (rows[:, END] > 0)
        names = np.array(self._names + [""], dtype=object)
        if name is not None:
            keep &= rows[:, NAME] == self._ids.get(name, -2)
        if prefix is not None:
            ids = [i for i, n in enumerate(self._names) if n.startswith(prefix)]
            keep &= np.isin(rows[:, NAME], ids)
        rows = rows[keep]
        rows = rows[np.argsort(rows[:, SEQ], kind="stable")]
        out = {f: rows[:, k] for k, f in enumerate(FIELDS) if not f.startswith(("key", "ord"))}
        out["name"] = names[rows[:, NAME]] if len(rows) else np.array([], dtype=object)
        for kcol, ocol in ((KEY0, ORD0), (KEY1, ORD1)):
            for key in np.unique(rows[:, kcol]):
                if key < 0:
                    continue
                col = out.setdefault(self._names[key], np.full(len(rows), -1, np.int64))
                hit = rows[:, kcol] == key
                col[hit] = rows[hit, ocol]
        return out

    def requests(self, since: int = 0) -> Dict[str, np.ndarray]:
        """The request records held (id at least ``since``), by id."""
        rows = self._reqs.copy()
        rows = rows[rows[:, RID] >= since]
        rows = rows[np.argsort(rows[:, RID], kind="stable")]
        return {f: rows[:, k] for k, f in enumerate(REQUEST_FIELDS)}

    def request_mark(self) -> int:
        return int(self._reqs[:, RID].max()) + 1


RECORDER = Recorder()


def span(name: str, **ordinals: int) -> Span:
    """A span of :data:`RECORDER`: ``with span("train.step", step=k) as sp:``."""
    return Span(RECORDER, name, ordinals)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to :data:`RECORDER`'s counter ``name``."""
    RECORDER.count(name, n)


def kineto_offsets(events, records: Dict[str, np.ndarray]) -> List[Tuple[str, int]]:
    """``(name, kineto start - recorder start)`` in ns for each profiled
    span of ``records`` (:meth:`Recorder.records`) and the host range of
    the same name in a profiler's kineto ``events``, paired in order of
    start."""
    by_name: Dict[str, List[int]] = collections.defaultdict(list)
    for e in events:
        n = e.name()
        if n.startswith(PREFIX) and e.device_type() == torch.autograd.DeviceType.CPU:
            by_name[n[len(PREFIX):]].append(int(e.start_ns()))
    ours: Dict[str, List[int]] = collections.defaultdict(list)
    for n, t, p in zip(records["name"], records["start"], records["profiled"]):
        if p:
            ours[n].append(int(t))
    out = []
    for n, starts in ours.items():
        for a, b in zip(sorted(by_name.get(n, ())), sorted(starts)):
            out.append((n, a - b))
    return out


@contextmanager
def trace_context(trace_dir: Optional[str], name: str = "trace"):
    """A ``torch.profiler`` window over the block when ``trace_dir`` is
    set (the host's ops, and the device's kernels where CUDA is there),
    written to ``trace_dir/<name>.json`` as a Chrome trace when the block
    ends; nothing otherwise.  The recorder's spans inside the block
    appear there as ``mca.*`` ranges."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(trace_dir, f"{name}.json")
    prof.export_chrome_trace(path)
    _log.info("profiler trace written to %s", path)
