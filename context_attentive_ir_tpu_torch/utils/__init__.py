"""Host-side utilities: meters, logging, metric records."""

from .logging import MetricsWriter, format_table, setup_logging
from .meters import AverageMeter, Timer

__all__ = ["AverageMeter", "Timer", "MetricsWriter", "format_table",
           "setup_logging"]
