"""A lock across processes around a build into a directory."""

from __future__ import annotations

import contextlib
import fcntl
from pathlib import Path


@contextlib.contextmanager
def build_lock(directory: Path):
    """Hold an exclusive `fcntl.flock` on ``directory/.lock`` (both made if
    missing) for the body: processes that build into one directory take
    turns, and a process that dies lets go of the lock with its file."""
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / ".lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield
