"""Host-side utilities: meters, logging, metric records, profiling."""

from .logging import MetricsWriter, format_table, setup_logging
from .meters import AverageMeter, Timer
from .profiling import debug_mode, profile_trace, timed

__all__ = ["AverageMeter", "Timer", "MetricsWriter", "format_table",
           "setup_logging", "debug_mode", "profile_trace", "timed"]
