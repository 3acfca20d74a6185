"""Host-side helpers. ``compile_cache`` (XLA's persistent compilation cache)
has no counterpart."""

from .logging import log, seed_everything
from .profiling import Throughput
