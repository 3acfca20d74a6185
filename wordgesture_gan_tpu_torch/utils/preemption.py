"""Graceful preemption: SIGTERM/SIGINT → finish the epoch, checkpoint, exit
(the single-process port of the JAX package's ``utils/preemption.py``).

The training loop wraps its epoch loop in a ``PreemptionGuard``: the first
signal requests a clean stop (the current epoch completes, a checkpoint is
written, the run returns so a rerun resumes where it left off); a second
signal raises ``KeyboardInterrupt`` at once."""

from __future__ import annotations

import signal


class PreemptionGuard:
    """Context manager latching SIGTERM/SIGINT into ``requested``. Off the
    main thread no handler is installed (Python allows ``signal.signal`` only
    there), and the loop simply runs unguarded."""

    _SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self.requested = False
        self._prev = {}

    def _handle(self, signum, frame):
        if self.requested:          # second signal: stop now
            raise KeyboardInterrupt
        self.requested = True

    def __enter__(self):
        for sig in self._SIGNALS:
            try:
                self._prev[sig] = signal.signal(sig, self._handle)
            except ValueError:      # not the main thread
                break
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        return False
