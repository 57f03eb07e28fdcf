"""A levelled logger: Trace, Debug, Info, Warn and Error levels, one
threshold for the process, timestamped lines.

Port of ``mitsuba_nlvrl_tpu/utils/logger.py``. ``Log(level, msg, *args)``
prints at or above the threshold (``set_log_level``), warnings and above
on stderr; an Error-level message raises."""
from __future__ import annotations

import sys
import time

Trace, Debug, Info, Warn, Error = 0, 100, 200, 300, 400

_NAMES = {Trace: 'TRACE', Debug: 'DEBUG', Info: 'INFO',
          Warn: 'WARN', Error: 'ERROR'}

_level = Info
_t0 = time.time()


def set_log_level(level: int) -> None:
    """The threshold below which messages are dropped."""
    global _level
    _level = level


def log_level() -> int:
    return _level


def Log(level: int, msg: str, *fmt_args, file=None) -> None:
    """Print a message at or above the current threshold. An Error-level
    message raises RuntimeError."""
    if fmt_args:
        msg = msg % fmt_args
    if level >= Error:
        raise RuntimeError(msg)
    if level < _level:
        return
    name = _NAMES.get(level, str(level))
    out = file or (sys.stderr if level >= Warn else sys.stdout)
    print(f"{time.time() - _t0:9.3f}s {name:5s} {msg}", file=out)
