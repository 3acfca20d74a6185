"""Graceful preemption: SIGTERM/SIGINT → finish the epoch, checkpoint, exit
(the port of the JAX package's ``utils/preemption.py``).

The training loop wraps its epoch loop in a ``PreemptionGuard``: the first
signal requests a clean stop (the current epoch completes, a checkpoint is
written, the run returns so a rerun resumes where it left off); a second
signal raises ``KeyboardInterrupt`` at once. In a data-parallel run the loop
asks ``agreed()``, so every rank stops on the same epoch."""

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

    def agreed(self, mesh=None) -> bool:
        """The stop decision of the whole run. A signal may reach only some
        ranks; if each acted on its own flag, the signalled ranks would
        checkpoint and exit while the rest waited in the next epoch's
        collectives. This max-reduces the flag over the ranks of ``mesh``
        (default: the process group's, if any), so every rank leaves the
        loop on the same epoch. It is a collective: every rank must call it
        at the same point of the loop. Without a process group it is
        ``requested``."""
        import torch.distributed as dist

        from ..parallel.mesh import create_mesh, max_over_ranks

        if mesh is None:
            if not dist.is_initialized():
                return self.requested
            import torch

            device = (torch.device("cuda", torch.cuda.current_device())
                      if dist.get_backend() == "nccl" else None)
            mesh = create_mesh(device=device)
        return max_over_ranks(mesh, self.requested)
