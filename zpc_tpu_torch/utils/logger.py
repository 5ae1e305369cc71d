"""Logging (counterpart of ``zpc_tpu/utils/logger.py``; reference
``Logger.hpp:14-29``, plog's rolling-file logger with ``ZS_LOG/ZS_WARN/
ZS_ERROR``).

The standard library's logging under the logger name ``zpc_tpu_torch``,
with an optional rotating file sink; the module-level functions mirror the
macros.  ``ZPC_TPU_LOGLEVEL`` sets the level, as in the JAX package.
"""

from __future__ import annotations

import logging
import logging.handlers
import os

__all__ = ["get_logger", "log", "warn", "error", "enable_file_logging"]

_NAME = "zpc_tpu_torch"


def get_logger() -> logging.Logger:
    """The package's logger, with a stream handler on first use."""
    lg = logging.getLogger(_NAME)
    if not lg.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "[%(asctime)s %(levelname).1s %(name)s] %(message)s",
            "%H:%M:%S"))
        lg.addHandler(h)
        lg.setLevel(os.environ.get("ZPC_TPU_LOGLEVEL", "INFO"))
    return lg


def enable_file_logging(path: str = "zpc_tpu_torch.log",
                        max_bytes: int = 8 << 20,
                        backups: int = 2) -> logging.Handler:
    """Add a rotating file sink (plog's rolling ``zensim_logs.log``) and
    return it, so that a caller can remove and close it."""
    h = logging.handlers.RotatingFileHandler(path, maxBytes=max_bytes,
                                             backupCount=backups)
    h.setFormatter(logging.Formatter(
        "[%(asctime)s %(levelname).1s] %(message)s"))
    get_logger().addHandler(h)
    return h


def log(msg, *args):
    get_logger().info(msg, *args)


def warn(msg, *args):
    get_logger().warning(msg, *args)


def error(msg, *args):
    get_logger().error(msg, *args)
