"""Tiny signal/slot replacement for the reference's Qt signals."""

from __future__ import annotations

import threading


class Event:
    """A thread-safe multicast callback, API-compatible enough with
    pyqtSignal for connect/disconnect/emit usage."""

    def __init__(self, *arg_types):
        self._callbacks = []
        self._lock = threading.Lock()

    def connect(self, callback):
        with self._lock:
            if callback not in self._callbacks:
                self._callbacks.append(callback)

    def disconnect(self, callback=None):
        with self._lock:
            if callback is None:
                self._callbacks.clear()
            elif callback in self._callbacks:
                self._callbacks.remove(callback)

    def emit(self, *args):
        with self._lock:
            callbacks = list(self._callbacks)
        for callback in callbacks:
            callback(*args)
