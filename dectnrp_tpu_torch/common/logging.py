"""Async-style file logging + fatal asserts (reference common/prog/log.hpp:
dectnrp_log_{inf,wrn,err} -> fmtlog async file logger with periodic
dectnrp_log_save() flush; common/prog/assert.hpp: dectnrp_assert fatal with
formatted message, compile-out via ENABLE_ASSERT -> here a runtime switch).

Copy of `dectnrp_tpu/common/logging.py`: the port imports nothing of the JAX
package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

import logging
import os

_logger = logging.getLogger("dectnrp")
_handler: logging.Handler | None = None

# runtime analogs of the reference's ENABLE_LOG / ENABLE_ASSERT cmake options
LOG_ENABLED = os.environ.get("DECTNRP_LOG", "1") != "0"
ASSERT_ENABLED = os.environ.get("DECTNRP_ASSERT", "1") != "0"


def log_setup(path: str = "log.txt", level: int = logging.INFO) -> None:
    """dectnrp_log_setup (dectnrp.cpp:55)."""
    global _handler
    if _handler is not None:
        _logger.removeHandler(_handler)
    _handler = logging.FileHandler(path, delay=True)
    _handler.setFormatter(logging.Formatter(
        "%(asctime)s.%(msecs)03d %(levelname).1s %(message)s",
        datefmt="%H:%M:%S"))
    _logger.addHandler(_handler)
    _logger.setLevel(level)


def log_inf(msg: str, *args) -> None:
    if LOG_ENABLED:
        _logger.info(msg, *args)


def log_wrn(msg: str, *args) -> None:
    if LOG_ENABLED:
        _logger.warning(msg, *args)


def log_err(msg: str, *args) -> None:
    if LOG_ENABLED:
        _logger.error(msg, *args)


def log_save() -> None:
    """dectnrp_log_save: flush buffered records (main loop, dectnrp.cpp:113)."""
    if _handler is not None:
        _handler.flush()


class DectAssertError(AssertionError):
    pass


def dectnrp_assert(cond: bool, msg: str = "", *args) -> None:
    """Fail-fast assert (reference real-time philosophy: fatal, formatted)."""
    if ASSERT_ENABLED and not cond:
        raise DectAssertError(msg % args if args else msg)
