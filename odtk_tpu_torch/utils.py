"""Helpers: a wall-clock profiler, a SIGINT guard, the rotated-box
corner helper and the metrics POST.

Copies of ``odtk_tpu/utils.py:Profiler``, ``ignore_sigint`` and
``rotate_box`` (the port imports nothing of ``odtk_tpu``), and
``post_metrics`` written with ``urllib`` in place of ``requests``.
"""

import signal
import time
import urllib.error
import urllib.parse
import urllib.request
import warnings
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


POST_TIMEOUT_S = 10     # a collector that hangs must not hold training


def post_metrics(url, metrics):
    """Push metric key/value pairs to an HTTP collector
    (``odtk_tpu/utils.py:post_metrics``).

    Each metric posts as form data (``time``, ``metric``, ``value``) with
    a nanosecond timestamp taken once for the whole batch. An error
    status is ignored, as ``requests.post`` ignores it; any other failure
    (collector down, no route, timeout) is reduced to a warning: metrics
    must never take down training.
    """
    stamp = int(time.time() * 1e9)
    try:
        for name, value in metrics.items():
            data = urllib.parse.urlencode(
                {'time': stamp, 'metric': name, 'value': value}).encode()
            try:
                urllib.request.urlopen(url, data=data,
                                       timeout=POST_TIMEOUT_S).close()
            except urllib.error.HTTPError as e:
                e.close()
    except Exception as e:  # noqa: BLE001
        warnings.warn('posting metrics to {} failed: {}'.format(url, e))
