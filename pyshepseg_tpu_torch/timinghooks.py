"""
Timing hooks (counterpart: pyshepseg_tpu/timinghooks.py; reference:
pyshepseg/timinghooks.py): the port's one facility for spans and counts.

:class:`Timers` is a thread-safe, pickleable collector of named time
intervals, used throughout the tiling drivers to time phases like
'reading', 'segmentation', 'stitchtiles'; worker processes pickle their
Timers back to the coordinator, which merges them. Its intervals are
always recorded. It also holds counts (:meth:`Timers.count`) and span
records.

The module-level :data:`TRACE` is a Timers that acts as the trace: while
a ``torch.profiler`` session runs in the process
(``torch.autograd.profiler._is_profiler_enabled``), it receives every
:func:`span`, every :meth:`Timers.interval` of any Timers and every
:func:`count`, and it is emptied when the next session starts. A span
record (:class:`Span`) holds its name, its start and end as
``time.time_ns()`` (the profiler's own clock for host events), its
thread, its parent (the enclosing span of the same thread) and the key
of its unit of work (:func:`unit`). On the thread that started the
profiler a span is also a ``record_function`` of the same name, so it
appears in the profiler's trace; the profiler records nothing of other
threads, whose spans are kept here alone. With no session running a span
or a count reads one flag and records nothing.
"""

import collections
import contextlib
import itertools
import threading
import time

import numpy
import torch
from torch.autograd import profiler as _profiler

# span records the trace holds; later ones are counted in Timers.dropped
MAX_SPANS = 1 << 20

# one span: times in ns on time.time_ns()'s clock; ``parent`` is the id
# of the enclosing span on the same thread (None at the top); ``key`` that
# of the unit of work (None outside any unit)
Span = collections.namedtuple(
    "Span", "name start end thread id parent key")


class Timers:
    """
    Collects multiple named timers. Each named timer accumulates a list of
    (startTime, endTime) interval pairs; use :meth:`interval` as a context
    manager around the code to be timed. All times in seconds (time.time).
    """

    def __init__(self):
        self.pairs = {}
        self.counts = {}
        self.spans = []
        self.dropped = 0
        self.lock = threading.Lock()

    @contextlib.contextmanager
    def interval(self, intervalName):
        """
        Context manager timing one named interval. While a profiler
        session runs, the interval is also a :func:`span` of the same
        name in :data:`TRACE`.
        """
        startTime = time.time()
        try:
            with span(intervalName):
                yield
        finally:
            endTime = time.time()
            with self.lock:
                self.pairs.setdefault(intervalName, []).append(
                    (startTime, endTime))

    def count(self, name, n=1):
        """Add ``n`` to the named count."""
        with self.lock:
            self.counts[name] = self.counts.get(name, 0) + n

    def addSpan(self, record):
        """Keep one :class:`Span`, or count it as dropped once MAX_SPANS
        are held."""
        with self.lock:
            if len(self.spans) < MAX_SPANS:
                self.spans.append(record)
            else:
                self.dropped += 1

    def clear(self):
        """Drop every interval, count and span."""
        with self.lock:
            self.pairs, self.counts, self.spans = {}, {}, []
            self.dropped = 0

    def getDurationsForName(self, intervalName):
        """List of durations (sec) for the named interval, or None."""
        if intervalName in self.pairs:
            return [(end - start) for (start, end) in
                    self.pairs[intervalName]]
        return None

    def merge(self, other):
        """Merge another Timers object into this one: its intervals,
        counts and spans. ``other`` is snapshotted under ITS lock first,
        so merging a Timers that worker threads are still updating
        neither raises (dict resized during iteration) nor drops a
        concurrent append."""
        with other.lock:
            snapshot = {name: list(pairs)
                        for name, pairs in other.pairs.items()}
            counts = dict(other.counts)
            spans, dropped = list(other.spans), other.dropped
        with self.lock:
            for name, pairs in snapshot.items():
                self.pairs.setdefault(name, []).extend(pairs)
            for name, n in counts.items():
                self.counts[name] = self.counts.get(name, 0) + n
            room = max(0, MAX_SPANS - len(self.spans))
            self.spans.extend(spans[:room])
            self.dropped += dropped + max(0, len(spans) - room)

    def makeSummaryDict(self):
        """
        Summary statistics per interval name: total/min/max/lowerq/median/
        upperq/mean/count (same keys as the reference,
        timinghooks.py:121-142).
        """
        d = {}
        for name in self.pairs:
            intervals = numpy.array(self.getDurationsForName(name))
            d[name] = {
                'total': float(intervals.sum()),
                'min': float(intervals.min()),
                'max': float(intervals.max()),
                'lowerq': float(numpy.percentile(intervals, 25)),
                'median': float(numpy.percentile(intervals, 50)),
                'upperq': float(numpy.percentile(intervals, 75)),
                'mean': float(intervals.mean()),
                'count': len(intervals),
            }
        return d

    def __getstate__(self):
        with self.lock:
            d = dict(self.__dict__)
        d.pop('lock')
        return d

    def __setstate__(self, state):
        self.lock = threading.Lock()
        with self.lock:
            self.__dict__.update(state)


# the trace: see the module's docstring
TRACE = Timers()
# off: what span() and unit() give while no profiler session runs
_OFF = contextlib.nullcontext()
_local = threading.local()
_spanIds = itertools.count(1)
_callIds = itertools.count(1)
_sessionLock = threading.Lock()
_sessionOn = False


def tracing():
    """Whether a ``torch.profiler`` session runs in the process (on any
    thread). A call that finds a session running, where the call before
    it found none, empties :data:`TRACE`: two sessions with no call
    between them share one trace (``TRACE.clear()`` parts them)."""
    global _sessionOn
    on = _profiler._is_profiler_enabled
    if on != _sessionOn:
        with _sessionLock:
            if on and not _sessionOn:
                TRACE.clear()
            _sessionOn = on
    return on


class _Span:
    """An open span; its record goes to TRACE when it closes."""
    __slots__ = ("name", "mirror", "id", "parent", "key", "start")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        self.id = next(_spanIds)
        self.key = getattr(_local, "key", None)
        stack.append(self.id)
        self.start = time.time_ns()
        self.mirror = None
        if torch._C._autograd._profiler_enabled():
            # this thread is the profiler's: the span joins its trace
            self.mirror = _profiler.record_function(self.name)
            self.mirror.__enter__()
        return self

    def __exit__(self, *exc):
        if self.mirror is not None:
            self.mirror.__exit__(*exc)
        end = time.time_ns()
        _local.stack.pop()
        TRACE.addSpan(Span(self.name, self.start, end, threading.get_ident(),
                           self.id, self.parent, self.key))
        return False


def span(name):
    """Context manager: one span named ``name`` in :data:`TRACE` while a
    profiler session runs; nothing otherwise."""
    if not tracing():
        return _OFF
    return _Span(name)


@contextlib.contextmanager
def _unit(key):
    outer = getattr(_local, "key", None)
    if key is None:
        key = outer if outer is not None else next(_callIds)
    _local.key = key
    try:
        yield key
    finally:
        _local.key = outer


def unit(key=None):
    """Context manager: the spans that this thread opens inside the block
    carry ``key``, which names one unit of work (a tile's ``(col, row)``).
    With no ``key`` an enclosing unit's key stands, or else the next call
    number. Nothing while no profiler session runs."""
    if not tracing():
        return _OFF
    return _unit(key)


def count(name, n=1):
    """Add ``n`` to the named count of :data:`TRACE` while a profiler
    session runs."""
    if tracing():
        TRACE.count(name, n)


# ---------------------------------------------------------------------
# Embedded self-tests, runnable without any test framework installed
# (reference: timinghooks.py:163-200 ships an AllTests unittest class
# with a mainCmd runner in the same module).


import unittest


class AllTests(unittest.TestCase):
    """Self-tests for the Timers class."""

    def test_interval_records_pair(self):
        t = Timers()
        with t.interval('phase'):
            time.sleep(0.01)
        durations = t.getDurationsForName('phase')
        self.assertEqual(len(durations), 1)
        # time.time() is not monotonic (NTP steps), so only assert a
        # sane non-negative duration rather than >= the sleep length
        self.assertGreaterEqual(durations[0], 0.0)
        self.assertIsNone(t.getDurationsForName('absent'))

    def test_interval_joins_the_trace(self):
        from torch.profiler import ProfilerActivity, profile
        t = Timers()
        with profile(activities=[ProfilerActivity.CPU]):
            with t.interval('device'):
                pass
        with t.interval('device'):
            pass
        self.assertEqual(len(t.getDurationsForName('device')), 2)
        self.assertEqual([s.name for s in TRACE.spans], ['device'])

    def test_merge(self):
        a = Timers()
        b = Timers()
        with a.interval('x'):
            pass
        with b.interval('x'):
            pass
        with b.interval('y'):
            pass
        a.merge(b)
        self.assertEqual(len(a.getDurationsForName('x')), 2)
        self.assertEqual(len(a.getDurationsForName('y')), 1)

    def test_summary_dict(self):
        t = Timers()
        for _ in range(4):
            with t.interval('p'):
                pass
        summary = t.makeSummaryDict()
        self.assertEqual(summary['p']['count'], 4)
        for key in ('total', 'min', 'max', 'lowerq', 'median', 'upperq',
                    'mean'):
            self.assertIn(key, summary['p'])
        self.assertGreaterEqual(summary['p']['max'], summary['p']['min'])

    def test_pickle_roundtrip(self):
        import pickle
        t = Timers()
        with t.interval('p'):
            pass
        t2 = pickle.loads(pickle.dumps(t))
        self.assertEqual(len(t2.getDurationsForName('p')), 1)
        # the restored object has a working lock
        with t2.interval('q'):
            pass

    def test_thread_safety(self):
        t = Timers()

        def work():
            for _ in range(50):
                with t.interval('p'):
                    pass

        threads = [threading.Thread(target=work) for _ in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        self.assertEqual(len(t.getDurationsForName('p')), 200)


def mainCmd():
    unittest.main(module=__name__, argv=['timinghooks'])


if __name__ == "__main__":
    mainCmd()
