"""Utilities (counterpart of ``zpc_tpu/utils``): profiling, logging and
IO."""

from .profile import Timer, bench, trace
from .logger import get_logger, log, warn, error, enable_file_logging
