"""Tracing, profiling and span recording (torch port of
gaussian_splat_ipu_tpu/utils/profiling.py).

  * Tracepoint: a named region that adds its host wall-clock seconds to a
    per-channel total and shows in torch.profiler traces while a profiler
    runs (torch.profiler.record_function, where the reference used
    jax.named_scope); while spans are recorded, also a span (below).
  * trace(): a context manager around torch.profiler.profile (CPU activity,
    and CUDA activity when a card is present) that writes a Chrome trace
    into a directory, where the reference wrapped jax.profiler.
  * Spans: start() turns recording on, span() and mark() place spans,
    collect() reads them, export_spans() writes them as a Chrome trace.

The per-channel totals are module state, as the reference's: one process
has one set (reset_tracepoints clears it).

Span recording. A span has a name, a start and an end on one clock (Unix
nanoseconds, time.time_ns: the clock of torch.profiler's events), a
parent, an item (the RenderEngine's index of the run it belongs to, -1
outside any) and a self time (its length less its direct children's). A
span is kept on two tracks:
  * "host": the host's time inside the `with` block;
  * "device": a span given a device whose tensors the recorder logs also
    launches a stamp at entry and at exit on that device's current stream.
    A stamp is a one-thread kernel (csrc/stamp.cu; a plain version for CPU
    tensors) that appends (tag, time) to a log in device memory, taking its
    slot with an atomic add on the log's cursor. Stamps launched while the
    engine captures a program become nodes of its CUDA graph, so every
    replay writes fresh entries, with replays in flight and no
    synchronisation. The log has a fixed capacity; stamps past it are
    counted as overflow and never wrap.
collect() synchronises, copies the log back once, resets its cursor on the
device and decodes it: a device span begins and ends at its stamps in
stream order, nests in the spans open around it there, and takes its item
from the nearest enclosing span that carries one (engine.run, stamped
outside the graph). Device times are mapped onto the host's clock by
anchors, taken after a synchronisation at start(), at each collect() and
at each anchor() call: on a card a handshake with a one-thread kernel
through page-locked memory, the host's clock read just before it answers
the kernel and just after the kernel's clock reading arrives (a bracket
of two trips over PCIe); a reading maps between the two anchors around it.
An anchor's error is half its bracket; the recorder keeps the largest.

mark(x, name) is an identity autograd Function that stamps in its forward
(an instant, `name + ".fwd"`) and in its backward; its backward stamp runs
as an autograd node on the forward's stream and ends the device span
`name + ".bwd"`, which begins where the span open around it began
(trainer.train_step: "loss.bwd" from the start of "backward" to the
gradient reaching the rendered image).

backward_begins(y, name) and backward_ends(x, name) place a device span
inside a backward pass: identity autograd Functions whose backward stamps
the span's start where y's gradient arrives and its end where x's does
(x upstream of y: parallel/distributed.py's "exchange.bwd" runs from the
received splats' gradient to the sent ones').

count(name, value) adds to the recorder's counter `name`: a number at
once (inside a CUDA-graph capture too, once, not on each replay), a
device tensor on its device, read back once by summary(). Inside a
capture a device tensor's add is captured into the graph, so it counts on
every replay, to a counter that a call before the capture made (the
engine's warm-ups make it); without one it is not counted.

Recording is off unless start() was called: span() then returns a shared
no-op context, mark() and the backward stamps return their input, count()
does nothing, nothing is stamped and runtime/engine.py's run checks one
module attribute (`active`).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import operator
import os
import threading
import time
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional

import torch

from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib

_channel_totals: Dict[str, float] = collections.defaultdict(float)
_channel_counts: Dict[str, int] = collections.defaultdict(int)

# The recorder while spans are recorded (start() .. stop()), else None.
active: Optional["SpanRecorder"] = None

# Entries of the device log by default: 16 B each, 16 MiB in all.
DEFAULT_CAPACITY = 1 << 20
# Stamp kinds, the low 2 bits of a tag; the name's id is in bits 2-31 and
# the item + 1 (0: none) in bits 32 up.
BEGIN, END, MARK_FWD, MARK_BWD = range(4)
# Anchors tried at each reading; the one with the narrowest bracket is kept.
ANCHOR_TRIES = 5
# How long the anchor kernel waits for the host's answer before it gives
# the try up.
ANCHOR_TIMEOUT_NS = 50_000_000
_NULL = contextlib.nullcontext()


class Tracepoint:
    """A region named `channel`: its host seconds and one count are added
    to the channel's totals; while torch.profiler runs, a record_function
    range of that name. While spans are recorded (and the recorder takes
    `channel`), also a span: on the host, and on `device`'s stream when
    the recorder logs that device; `item` numbers it and the spans inside
    it. A class, not a generator, to keep a span's own cost low."""

    __slots__ = ("channel", "device", "item", "_t0", "_range", "_rec",
                 "_node")

    def __init__(self, channel: str, device=None,
                 item: Optional[int] = None):
        self.channel, self.device, self.item = channel, device, item

    def __enter__(self):
        self._t0 = time.perf_counter()
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.channel)
            self._range.__enter__()
        rec = active
        self._rec = rec if rec is not None and rec.takes(self.channel) \
            else None
        if self._rec is not None:
            self._node = self._rec.enter(self.channel, self.device,
                                         self.item)
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec.exit(self._node)
        if self._range is not None:
            self._range.__exit__(*exc)
        _channel_totals[self.channel] += time.perf_counter() - self._t0
        _channel_counts[self.channel] += 1
        return False


def tracepoint_summary() -> Dict[str, Dict[str, float]]:
    """{channel: {"total_s": host seconds, "count": regions}}."""
    return {ch: {"total_s": _channel_totals[ch],
                 "count": _channel_counts[ch]}
            for ch in _channel_totals}


def reset_tracepoints() -> None:
    _channel_totals.clear()
    _channel_counts.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with torch.profiler (CUDA activity too when a
    card is present) and write its Chrome trace (view with Perfetto or
    chrome://tracing) into log_dir as trace.json. Yields the profiler,
    whose key_averages() sums the block's events by name."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# -- spans -------------------------------------------------------------------

class Span(NamedTuple):
    name: str
    track: str       # "host" or "device"
    start_ns: int    # Unix nanoseconds (time.time_ns's clock)
    end_ns: int
    parent: int      # index of the enclosing span in the same list, or -1
    item: int        # the engine's run index, or -1
    self_ns: int     # end - start less the direct children's lengths


class Anchor(NamedTuple):
    host_ns: int     # the middle of the host's bracket
    device_ns: int   # the stamp's own reading
    error_ns: int    # half the bracket


_device_ns = operator.attrgetter("device_ns")


def stamp_torch(log: torch.Tensor, state: torch.Tensor, tag: int,
                now_ns: int) -> None:
    """Plain version of csrc/stamp.cu: append (tag, now_ns) to `log` at
    the slot its cursor state[0] gives; past the capacity count state[1]
    instead."""
    slot = int(state[0])
    state[0] += 1
    if slot < log.shape[0]:
        log[slot, 0] = tag
        log[slot, 1] = now_ns
    else:
        state[1] += 1


class _Node:
    """A span being assembled: its children are kept until the outermost
    open span closes, then the tree is numbered parent first."""

    __slots__ = ("name", "start", "end", "item", "children", "stamped")

    def __init__(self, name, start, item):
        self.name, self.start, self.end = name, start, start
        self.item, self.children, self.stamped = item, [], False


class SpanRecorder:
    """The spans of one recording (module docstring). `device`: the device
    whose stamps it logs (None: host spans only); `capacity`: log entries;
    `only`: the span names it takes (None: every name); `clock`: the host
    clock, in Unix nanoseconds (CPU stamps read it too)."""

    def __init__(self, device=None, capacity: int = DEFAULT_CAPACITY,
                 only: Optional[Iterable[str]] = None,
                 clock: Callable[[], int] = time.time_ns):
        if device is not None:
            device = torch.device(device)
            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.capacity = int(capacity)
        self.only = frozenset(only) if only is not None else None
        self.clock = clock
        self.spans: List[Span] = []
        self.counters: collections.Counter = collections.Counter()
        self.device_counters: Dict[str, torch.Tensor] = {}
        self.items = 0            # engine runs numbered so far
        self.entries = 0          # log entries read
        self.overflow = 0         # stamps past the capacity
        self.anchors: List[Anchor] = []
        self._names: Dict[str, int] = {}
        self._name_list: List[str] = []
        self._host = threading.local()
        self._open: List[_Node] = []   # device spans open in the log
        self.log = self.state = self._lib = None
        if device is not None:
            self.log = torch.zeros((self.capacity, 2), dtype=torch.int64,
                                   device=device)
            self.state = torch.zeros(2, dtype=torch.int64, device=device)
            if device.type == "cuda":
                # The stamp's arguments, read once: a stamp launched
                # outside a graph costs its launch and little more.
                self._lib = cuda_lib.library()
                self._log_ptr = self.log.data_ptr()
                self._state_ptr = self.state.data_ptr()
                self._words = torch.zeros(4, dtype=torch.int64,
                                          pin_memory=True)
            self.anchor()

    # -- recording ------------------------------------------------------------

    def takes(self, name: str) -> bool:
        return self.only is None or name in self.only

    def logs(self, device) -> bool:
        """Whether stamps on `device` go to this recorder's log."""
        if self.device is None or device is None:
            return False
        if not isinstance(device, torch.device):
            device = torch.device(device)
        return device == self.device

    def next_item(self) -> int:
        k = self.items
        self.items += 1
        return k

    def _tag(self, name: str, kind: int, item: int) -> int:
        nid = self._names.get(name)
        if nid is None:
            nid = self._names[name] = len(self._name_list)
            self._name_list.append(name)
        return ((item + 1) << 32) | (nid << 2) | kind

    def stamp(self, name: str, kind: int, item: int = -1) -> None:
        """Append one stamp of `name` to the log on the current stream."""
        tag = self._tag(name, kind, item)
        if self._lib is None:
            stamp_torch(self.log, self.state, tag, self.clock())
            return
        rc = self._lib.gsplat_stamp(
            self._log_ptr, self._state_ptr, self.capacity, tag,
            torch._C._cuda_getCurrentRawStream(self.device.index))
        if rc:
            cuda_lib.check("gsplat_stamp", rc)
        cuda_lib.launches["stamp"] += 1

    def _stack(self) -> list:
        st = getattr(self._host, "stack", None)
        if st is None:
            st = self._host.stack = []
        return st

    def enter(self, name: str, device=None, item: Optional[int] = None):
        """Open a host span (and, when this recorder logs `device`, stamp a
        device span's start); returns the node that exit() closes."""
        st = self._stack()
        if item is None:
            item = st[-1].item if st else -1
        stamped = self.logs(device)
        if stamped:
            self.stamp(name, BEGIN, item)
        node = _Node(name, self.clock(), item)
        node.stamped = stamped
        st.append(node)
        return node

    def exit(self, node: "_Node") -> None:
        node.end = self.clock()
        st = self._stack()
        st.pop()
        if node.stamped:
            self.stamp(node.name, END)
        if st:
            st[-1].children.append(node)
        else:
            self._flush(node, "host", -1)

    def _flush(self, node: _Node, track: str, parent: int) -> None:
        idx = len(self.spans)
        dur = node.end - node.start
        kids = sum(c.end - c.start for c in node.children)
        self.spans.append(Span(node.name, track, node.start, node.end,
                               parent, node.item, dur - kids))
        for c in node.children:
            self._flush(c, track, idx)

    # -- reading --------------------------------------------------------------

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def anchor(self) -> Anchor:
        """Read the device's clock against the host's: the narrowest of
        ANCHOR_TRIES brackets. On a card a handshake through page-locked
        memory (csrc/stamp.cu's anchor_kernel): the host's clock read
        before it answers the running kernel and after the kernel's
        reading arrives. On the CPU the log's plain stamps read the host's
        clock itself: three readings in a row."""
        best = None
        for _ in range(ANCHOR_TRIES):
            a = self._handshake() if self.device.type == "cuda" \
                else self._bracket()
            if a is not None and (best is None or a.error_ns < best.error_ns):
                best = a
        if best is None:
            raise RuntimeError("no anchor: the anchor kernel never heard the "
                               "host")
        self.anchors.append(best)
        return best

    def _bracket(self) -> Anchor:
        h0 = self.clock()
        t = self.clock()      # the plain stamp's reading
        h1 = self.clock()
        return Anchor((h0 + h1) // 2, t, (h1 - h0 + 1) // 2)

    def _handshake(self) -> Optional[Anchor]:
        """One handshake with anchor_kernel; None if it timed out."""
        words = self._words.numpy()
        words[:] = 0
        self._sync()
        cuda_lib.check("gsplat_anchor", self._lib.gsplat_anchor(
            self._words.data_ptr(), ANCHOR_TIMEOUT_NS,
            cuda_lib.stream_handle(self.device)))
        cuda_lib.launches["anchor"] += 1
        deadline = time.perf_counter() + 10.0
        while words[1] == 0:
            if time.perf_counter() > deadline:
                raise RuntimeError("the anchor kernel did not start")
        h0 = self.clock()
        words[0] = 1
        while words[2] == 0:
            if time.perf_counter() > deadline:
                raise RuntimeError("the anchor kernel did not answer")
        h1 = self.clock()
        self._sync()
        if words[3]:
            return None
        return Anchor((h0 + h1) // 2, int(words[2]), (h1 - h0 + 1) // 2)

    @property
    def anchor_error_ns(self) -> int:
        return max((a.error_ns for a in self.anchors), default=0)

    def to_host(self, t: int) -> int:
        """A device reading on the host's clock: between the two anchors
        around it in device time (past the ends, through the nearest
        two). Anchors are taken in time order, so the list is sorted."""
        a = self.anchors
        if len(a) == 1:
            return a[0].host_ns + (t - a[0].device_ns)
        i = min(max(bisect.bisect(a, t, key=_device_ns) - 1, 0),
                len(a) - 2)
        lo, hi = a[i], a[i + 1]
        if hi.device_ns == lo.device_ns:
            return lo.host_ns + (t - lo.device_ns)
        rate = (hi.host_ns - lo.host_ns) / (hi.device_ns - lo.device_ns)
        return lo.host_ns + round((t - lo.device_ns) * rate)

    def collect(self) -> List[Span]:
        """Synchronise, read the log's new entries, reset its cursor and
        add their spans; returns every span recorded so far."""
        if self.log is None:
            return self.spans
        self._sync()
        n_total, over = (int(x) for x in self.state.tolist())
        n = min(n_total, self.capacity)
        entries = self.log[:n].tolist() if n else []
        self.state.zero_()
        self.anchor()
        self.entries += n
        self.overflow += over
        self._decode(entries)
        return self.spans

    def _decode(self, entries) -> None:
        st = self._open
        for tag, t in entries:
            kind, nid, item = tag & 3, (tag >> 2) & 0x3FFFFFFF, \
                (tag >> 32) - 1
            name, t = self._name_list[nid], self.to_host(t)
            if kind == BEGIN:
                if item < 0 and st:
                    item = st[-1].item
                st.append(_Node(name, t, item))
                continue
            if kind == END:
                j = next((j for j in range(len(st) - 1, -1, -1)
                          if st[j].name == name), None)
                if j is None:
                    continue   # begun before a clear()
                # Spans begun inside it and never ended (an overflow):
                # their finished children move up to it.
                for lost in st[j + 1:]:
                    st[j].children.extend(lost.children)
                del st[j + 1:]
                node = st.pop()
                node.end = t
            elif not st:
                continue
            elif kind == MARK_FWD:
                node = _Node(name + ".fwd", t, st[-1].item)
            else:
                node = _Node(name + ".bwd", st[-1].start, st[-1].item)
                node.end = t
            if st:
                st[-1].children.append(node)
            else:
                self._flush(node, "device", -1)

    def clear(self) -> None:
        """Drop the spans read so far and reset the log's cursor on the
        device (on the current stream: stamps in flight land after it)."""
        if self.state is not None:
            self.state.zero_()
        self.spans = []
        self._open = []

    def summary(self) -> dict:
        """The counters: engine runs (items), replays and captures per
        program, bytes copied in per replay, log entries and overflow, the
        anchors' error, and whether the kernel library was built (its nvcc
        seconds) or loaded (0.0)."""
        replays = sum(v for k, v in self.counters.items()
                      if k.startswith("replays."))
        counted = collections.Counter(self.counters)
        for name, acc in self.device_counters.items():
            counted[name] += int(acc)
        return dict(counted, items=self.items,
                    copy_in_bytes_per_replay=(
                        self.counters["copy_in_bytes"] / replays
                        if replays else None),
                    log_entries=self.entries, log_overflow=self.overflow,
                    anchor_error_ns=self.anchor_error_ns,
                    kernel_build_s=cuda_lib.BuildInfo.seconds)


# -- the module's recorder -----------------------------------------------------

def start(device=None, capacity: int = DEFAULT_CAPACITY,
          only: Optional[Iterable[str]] = None,
          clock: Callable[[], int] = time.time_ns) -> SpanRecorder:
    """Turn recording on (SpanRecorder's arguments). Programs captured
    from here on hold the stamps; a capture keeps its recorder's log alive
    for as long as the graph lives."""
    global active
    if active is not None:
        raise RuntimeError("spans are already being recorded")
    active = SpanRecorder(device, capacity, only, clock)
    return active


def stop() -> Optional[SpanRecorder]:
    """Read the log once more and turn recording off; returns the
    recorder (None if none was recording)."""
    global active
    rec, active = active, None
    if rec is not None:
        rec.collect()
    return rec


def span(name: str, device=None, item: Optional[int] = None):
    """A Tracepoint while spans are recorded; otherwise a shared no-op
    context."""
    rec = active
    if rec is None or not rec.takes(name):
        return _NULL
    return Tracepoint(name, device, item)


class _Mark(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rec, name):
        rec.stamp(name, MARK_FWD)
        ctx.rec, ctx.name = rec, name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.rec.stamp(ctx.name, MARK_BWD)
        return grad, None, None


def mark(x: torch.Tensor, name: str) -> torch.Tensor:
    """x itself, stamped where the forward passes it and, through an
    identity autograd node, where its gradient arrives (module docstring).
    Without a recorder that logs x's device: x, and no node."""
    rec = active
    if rec is None or rec.only is not None or not rec.logs(x.device):
        return x
    if not x.requires_grad:
        rec.stamp(name, MARK_FWD)
        return x
    return _Mark.apply(x, rec, name)


class _BackwardStamp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rec, name, kind):
        ctx.rec, ctx.name, ctx.kind = rec, name, kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.rec.stamp(ctx.name, ctx.kind)
        return grad, None, None, None


def _backward_stamp(x: torch.Tensor, name: str, kind: int) -> torch.Tensor:
    rec = active
    if (rec is None or not rec.takes(name) or not rec.logs(x.device)
            or not (torch.is_grad_enabled() and x.requires_grad)):
        return x
    return _BackwardStamp.apply(x, rec, name, kind)


def backward_begins(y: torch.Tensor, name: str) -> torch.Tensor:
    """y itself; where its gradient arrives, the device span `name`
    begins (module docstring)."""
    return _backward_stamp(y, name, BEGIN)


def backward_ends(x: torch.Tensor, name: str) -> torch.Tensor:
    """x itself; where its gradient arrives, the device span `name`
    ends (module docstring)."""
    return _backward_stamp(x, name, END)


def count(name: str, value) -> None:
    """Add `value` (a number, or a one-element tensor added on its device
    without a read-back) to the recorder's counter `name` while spans are
    recorded; inside a CUDA-graph capture, as the module docstring says."""
    rec = active
    if rec is None:
        return
    if not isinstance(value, torch.Tensor):
        rec.counters[name] += value
        return
    value = value.detach().to(torch.int64)
    acc = rec.device_counters.get(name)
    if value.is_cuda and torch.cuda.is_current_stream_capturing():
        if acc is not None and acc.device == value.device:
            acc.add_(value)
        return
    if acc is None:
        rec.device_counters[name] = value.clone()
    else:
        acc.add_(value.to(device=acc.device))


def clear() -> None:
    if active is not None:
        active.clear()


def collect() -> List[Span]:
    return active.collect() if active is not None else []


# -- readings of spans -----------------------------------------------------------

def item_ms(spans: Iterable[Span], name: str,
            track: str = "device") -> Dict[int, float]:
    """{item: milliseconds} of the spans `name` on `track`, summed per
    item; spans outside any item are left out."""
    out: Dict[int, float] = {}
    for s in spans:
        if s.name == name and s.track == track and s.item >= 0:
            out[s.item] = out.get(s.item, 0.0) + (s.end_ns - s.start_ns) / 1e6
    return out


def coverage(spans: List[Span], parent: str = "engine.run") -> Dict[int,
                                                                    float]:
    """{item: share} of each device span `parent` covered by its direct
    children."""
    out = {}
    for i, s in enumerate(spans):
        if s.name == parent and s.track == "device" and s.item >= 0:
            dur = s.end_ns - s.start_ns
            out[s.item] = (dur - s.self_ns) / dur if dur > 0 else 0.0
    return out


def union_ns(spans: Iterable[Span], names: Iterable[str], t0: int,
             t1: int) -> int:
    """Nanoseconds of [t0, t1] covered by device spans of these names."""
    names = set(names)
    ivs = sorted((max(s.start_ns, t0), min(s.end_ns, t1)) for s in spans
                 if s.track == "device" and s.name in names)
    total, cur_s, cur_e = 0, None, None
    for a, b in ivs:
        if b <= a:
            continue
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def export_spans(path: str, rec: Optional[SpanRecorder] = None) -> str:
    """Write the recorder's spans (the module's by default, read first) as
    Chrome trace JSON, which Perfetto opens: host spans in one process,
    device spans in another, on the shared clock in microseconds from the
    first anchor (or the first span); each event's args hold its item,
    parent index and self time. Returns path."""
    rec = rec or active
    if rec is None:
        raise RuntimeError("no span recorder")
    spans = rec.collect()
    origin = rec.anchors[0].host_ns if rec.anchors else min(
        (s.start_ns for s in spans), default=0)
    pid = {"host": 0, "device": 1}
    events = [{"ph": "M", "pid": p, "name": "process_name",
               "args": {"name": f"{track} ({rec.device})"
                        if track == "device" else track}}
              for track, p in pid.items()]
    for i, s in enumerate(spans):
        events.append({"name": s.name, "ph": "X", "pid": pid[s.track],
                       "tid": 0, "ts": (s.start_ns - origin) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"index": i, "item": s.item,
                                "parent": s.parent,
                                "self_us": s.self_ns / 1e3}})
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": {"clock": "unix_ns",
                                 "origin_unix_ns": origin,
                                 "counters": rec.summary()}}, f)
    return path
