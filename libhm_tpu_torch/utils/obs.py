"""Spans of the decoder's host stages, recorded where the work happens.

    with obs.request() as r:            # the root span "decode"
        with obs.span("prep.residual") as s:
            tables = residual_tables(items)
            s.n = sum(len(t[0]) for t in tables)
        ...
        r.n = len(pictures)

    obs.count("k2.plane_blocks", n)     # a count, under the open span
    obs.spans(since=t0, until=t1)       # the entries that ran in [t0, t1]

Each span closed is one entry: span id, parent span id, request id, name,
start and end on time.perf_counter(), the thread that ran it, and `n`,
the work items it processed (pictures, blocks, TUs, bytes or NAL units;
each call site says which), counted at the same boundary as the time.
A count is an entry of no duration (t0 == t1) under the open span: a
number taken at one point, which a reader finds through its parent.

A span opened under another inherits its request id; the open span is a
contextvars variable, so each thread has its own stack, and work handed
to another thread carries its caller's span in contextvars.copy_context()
(decode_streams' parse threads).  Entries go into a ring of CAPACITY; an
entry that pushes the oldest out counts in `dropped`.

Recording is on by default and host-only: a span reads the host clock
and appends a tuple, and never synchronizes a device, records a CUDA
event or launches work.  enable(False) makes every span a no-op.
"""
import contextvars
import itertools
import threading
import time
from collections import deque, namedtuple

Span = namedtuple("Span", "id parent request name t0 t1 thread n")

CAPACITY = 65536

dropped = 0
_ring = deque(maxlen=CAPACITY)
_lock = threading.Lock()
_ids = itertools.count(1)
_on = True
# (span id, request id) of the innermost open span of this context
_current = contextvars.ContextVar("libhm_tpu_torch_obs_span",
                                  default=(None, None))


class _Open:
    """One open span; `n` may be set before it closes."""
    __slots__ = ("name", "n", "root", "id", "parent", "request", "t0",
                 "token")

    def __init__(self, name, n, root):
        self.name, self.n, self.root = name, n, root
        self.token = None

    def __enter__(self):
        if not _on:
            return self
        self.parent, self.request = _current.get()
        self.id = next(_ids)
        if self.root:
            self.request = self.id
        self.token = _current.set((self.id, self.request))
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.token is None:
            return False
        t1 = time.perf_counter()
        _current.reset(self.token)
        self.token = None
        _record(Span(self.id, self.parent, self.request, self.name, self.t0,
                     t1, threading.get_ident(), self.n))
        return False


def _record(entry):
    global dropped
    with _lock:
        if len(_ring) == CAPACITY:
            dropped += 1
        _ring.append(entry)


def span(name, n=0):
    """A context manager that records one span called `name` with `n`
    work items (settable as .n inside the block)."""
    return _Open(name, n, False)


def count(name, n):
    """Record `n` under `name` as an entry of no duration under the open
    span (its parent), at this point of the host clock."""
    if not _on:
        return
    parent, request_id = _current.get()
    t = time.perf_counter()
    _record(Span(next(_ids), parent, request_id, name, t, t,
                 threading.get_ident(), n))


def request(n=0):
    """The root span "decode" of one call into the decoder: its own id is
    the request id that the spans opened under it carry."""
    return _Open("decode", n, True)


def spans(since=None, until=None):
    """The recorded entries, oldest closed first, with since <= t0 and
    t1 <= until where those are given."""
    with _lock:
        out = list(_ring)
    return [s for s in out if (since is None or s.t0 >= since) and
            (until is None or s.t1 <= until)]


def reset():
    """Forget every entry and the dropped count."""
    global dropped
    with _lock:
        _ring.clear()
        dropped = 0


def enable(flag):
    """Record spans (True, the default) or make every span a no-op."""
    global _on
    _on = bool(flag)
