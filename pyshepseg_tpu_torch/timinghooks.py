"""
Timing hooks: a thread-safe, pickleable collector of named time intervals
(counterpart: pyshepseg_tpu/timinghooks.py; reference:
pyshepseg/timinghooks.py). Used throughout the tiling drivers to time
phases like 'reading', 'segmentation', 'stitchtiles'; worker processes
pickle their Timers back to the coordinator, which merges them.

On top of the reference surface, :meth:`Timers.interval` optionally waits
for queued CUDA work (``sync=True``) so device phases are timed honestly:
PyTorch launches return before the card finishes, and would otherwise
attribute device time to whichever phase happens to synchronise.
"""

import time
import threading
import contextlib

import numpy
import torch


class Timers:
    """
    Collects multiple named timers. Each named timer accumulates a list of
    (startTime, endTime) interval pairs; use :meth:`interval` as a context
    manager around the code to be timed. All times in seconds (time.time).
    """

    def __init__(self):
        self.pairs = {}
        self.lock = threading.Lock()

    @contextlib.contextmanager
    def interval(self, intervalName, sync=False):
        """
        Context manager timing one named interval. If ``sync`` is True and
        CUDA has been initialised in this process, waits for all queued
        work on the current CUDA device (``torch.cuda.synchronize()``)
        before reading the end time; use it around device compute phases.
        A block that already copies its results to the host does not need
        it.
        """
        startTime = time.time()
        try:
            yield
        finally:
            if sync and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            endTime = time.time()
            with self.lock:
                self.pairs.setdefault(intervalName, []).append(
                    (startTime, endTime))

    def getDurationsForName(self, intervalName):
        """List of durations (sec) for the named interval, or None."""
        if intervalName in self.pairs:
            return [(end - start) for (start, end) in
                    self.pairs[intervalName]]
        return None

    def merge(self, other):
        """Merge another Timers object into this one. ``other`` is
        snapshotted under ITS lock first, so merging a Timers that
        worker threads are still updating neither raises (dict resized
        during iteration) nor drops a concurrent append."""
        with other.lock:
            snapshot = {name: list(pairs)
                        for name, pairs in other.pairs.items()}
        with self.lock:
            for name, pairs in snapshot.items():
                self.pairs.setdefault(name, []).extend(pairs)

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

    def test_sync_interval(self):
        t = Timers()
        with t.interval('device', sync=True):
            pass
        self.assertEqual(len(t.getDurationsForName('device')), 1)

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
