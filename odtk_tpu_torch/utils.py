"""Helpers: a wall-clock profiler, a SIGINT guard and the rotated-box
corner helper.

Copies of ``odtk_tpu/utils.py:Profiler``, ``ignore_sigint`` and
``rotate_box`` (the port imports nothing of ``odtk_tpu``).
"""

import signal
import time
from contextlib import contextmanager

import numpy as np


def rotate_box(bbox):
    """Corners of (x, y, w, h, theta) rotated about the box center, as a
    flat [x0, y0, ..., x3, y3] list in corner order (tl, bl, br, tr): the
    ``segmentation`` polygon of a rotated detection."""
    x, y, w, h, theta = bbox
    cx, cy = x + (w - 1) / 2.0, y + (h - 1) / 2.0
    base = np.array([[x, y], [x, y + h - 1],
                     [x + w - 1, y + h - 1], [x + w - 1, y]], np.float64)
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s], [s, c]])
    corners = (base - [cx, cy]) @ rot.T + [cx, cy]
    return corners.reshape(-1).tolist()


@contextmanager
def ignore_sigint():
    """Defer Ctrl-C while a checkpoint is written."""
    handler = signal.getsignal(signal.SIGINT)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    try:
        yield
    finally:
        signal.signal(signal.SIGINT, handler)


class _Lap:
    """One named stopwatch: accumulated seconds + completed laps."""

    __slots__ = ('mark', 'total', 'laps')

    def __init__(self):
        self.mark = time.perf_counter()
        self.total = 0.0
        self.laps = 0


class Profiler:
    """A set of named wall-clock stopwatches (monotonic clock).

    ``start``/``stop`` bracket a lap; ``bump`` closes the current lap
    and immediately opens the next (per-iteration cadence timing).
    ``totals`` and ``means`` expose accumulated seconds and per-lap
    averages as dict views for status lines.
    """

    def __init__(self, names=('main',)):
        self._laps = {n: _Lap() for n in names}

    def reset(self):
        for lap in self._laps.values():
            lap.__init__()

    def start(self, name='main'):
        self._laps[name].mark = time.perf_counter()

    def stop(self, name='main'):
        lap = self._laps[name]
        lap.total += time.perf_counter() - lap.mark
        lap.laps += 1

    def bump(self, name='main'):
        self.stop(name)
        self.start(name)

    @property
    def totals(self):
        return {n: lap.total for n, lap in self._laps.items()}

    @property
    def counts(self):
        return {n: lap.laps for n, lap in self._laps.items()}

    @property
    def means(self):
        return {n: lap.total / lap.laps if lap.laps else 0.0
                for n, lap in self._laps.items()}
