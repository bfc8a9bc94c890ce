"""Thread-tagged dual-sink logging (copy of the JAX package's
utils/log.py; ref: src/util/log/fd_log.h — brief
ephemeral sink on stderr + detailed permanent file sink, every line
tagged with wallclock, app/tile identity, pid and level).

One logger per process (tiles call init() at boot with their tile
name); levels follow the reference's ladder. The permanent sink gets
every level; stderr only NOTICE and above by default so tile stdout
stays quiet in production topologies (the stem logs lifecycle events
and failures through this)."""
from __future__ import annotations

import os
import sys
import threading
import time

DEBUG, INFO, NOTICE, WARNING, ERR, CRIT = 0, 1, 2, 3, 4, 5
_NAMES = {DEBUG: "DEBUG", INFO: "INFO", NOTICE: "NOTICE",
          WARNING: "WARNING", ERR: "ERR", CRIT: "CRIT"}

_lock = threading.Lock()
_state = {"name": "?", "file": None, "stderr_level": NOTICE,
          "file_level": DEBUG}


def init(name: str, path: str | None = None,
         stderr_level: int = NOTICE, file_level: int = DEBUG):
    """Configure this process's logger. path=None -> env
    FDTPU_LOG_PATH -> no permanent sink."""
    with _lock:
        _state["name"] = name
        _state["stderr_level"] = stderr_level
        _state["file_level"] = file_level
        path = path or os.environ.get("FDTPU_LOG_PATH")
        if _state["file"] is not None:
            try:
                _state["file"].close()
            except OSError:
                pass
            _state["file"] = None
        if path:
            _state["file"] = open(path, "a", buffering=1)


def _emit(level: int, msg: str):
    now = time.time()
    stamp = time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime(now))
    line = (f"{stamp}.{int(now * 1e6) % 1_000_000:06d} "
            f"{_NAMES[level]:<7} {_state['name']}:{os.getpid()} {msg}")
    with _lock:
        if level >= _state["stderr_level"]:
            print(line, file=sys.stderr, flush=True)
        f = _state["file"]
        if f is not None and level >= _state["file_level"]:
            f.write(line + "\n")


def debug(msg):
    _emit(DEBUG, msg)


def info(msg):
    _emit(INFO, msg)


def notice(msg):
    _emit(NOTICE, msg)


def warning(msg):
    _emit(WARNING, msg)


def err(msg):
    _emit(ERR, msg)


def crit(msg):
    _emit(CRIT, msg)
