"""Advisory single-device lock: keep benches and training off the GPU at
the same time (counterpart of adafocus_tpu/utils/device_lock.py).

A bench that runs beside a training run on the same card measures the
contention, not the program. Long training runs hold the lock
(``device_lock()``); benches call ``wait_for_device(timeout)`` before they
time and, if the holder outlives the timeout, go on and tag their numbers
as contended. The lock is a JSON file with the holder's pid and a note; a
lock whose pid is dead is stale and counts as free, so a crash never
wedges the card.

Three things differ from the JAX package's lock, on purpose: a pid <= 0
(a corrupt file, or one written by hand) is not a live holder here
(``os.kill`` with pid 0 or -1 probes a process group, not a process);
``device_lock`` never overwrites a live holder's lock: it waits for it to
go, then takes it, or raises ``TimeoutError`` with the holder's pid and
note; and a holder that is alive but owned by another user
(``PermissionError`` from the probe) is live, not stale.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional, Tuple

DEFAULT_LOCK = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".data", "gpu_busy.lock")


def _holder(path: str) -> Optional[Tuple[int, str]]:
    """(pid, note) of a live holder, else None (absent, corrupt, dead or
    not a process id)."""
    try:
        with open(path) as f:
            info = json.load(f)
        pid = int(info.get("pid", -1))
    except (OSError, ValueError, TypeError, AttributeError):
        return None
    if pid <= 0:
        return None
    try:
        os.kill(pid, 0)  # liveness probe, no signal delivered
    except ProcessLookupError:
        return None
    except PermissionError:
        pass  # alive, owned by another user
    except OSError:
        return None
    return pid, str(info.get("note", ""))


def _timeout(timeout_secs: Optional[float]) -> float:
    if timeout_secs is None:
        return float(os.environ.get("ADAFOCUS_BENCH_WAIT_SECS", 1800))
    return timeout_secs


def _try_create(path: str, note: str) -> bool:
    """Write the lock file if none exists (``O_EXCL``: one writer wins)."""
    try:
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o644)
    except FileExistsError:
        return False
    with os.fdopen(fd, "w") as f:
        json.dump({"pid": os.getpid(), "note": note, "started": time.time()}, f)
    return True


@contextlib.contextmanager
def device_lock(note: str = "", path: str = DEFAULT_LOCK,
                timeout_secs: Optional[float] = None, poll_secs: float = 15.0):
    """Hold the advisory GPU lock for the duration of a training run.

    A stale lock (dead holder, corrupt file) is replaced. A live holder's
    lock is not: this waits until it is gone (``timeout_secs``, default as
    ``wait_for_device``'s) and raises ``TimeoutError`` naming the holder if
    it is still there. The lock file is removed on exit if it is still
    this process's."""
    timeout_secs = _timeout(timeout_secs)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    deadline = time.time() + timeout_secs
    while not _try_create(path, note):
        holder = _holder(path)
        if holder is None:
            with contextlib.suppress(FileNotFoundError):
                os.remove(path)   # stale: break it and try again
            continue
        if time.time() >= deadline:
            raise TimeoutError(f"device_lock: pid {holder[0]} ({holder[1]!r}) holds the GPU "
                               f"lock {path} after {timeout_secs:.0f}s")
        time.sleep(poll_secs)
    try:
        yield
    finally:
        with contextlib.suppress(OSError):
            live = _holder(path)
            if live is None or live[0] == os.getpid():
                os.remove(path)


def wait_for_device(timeout_secs: float | None = None,
                    path: str = DEFAULT_LOCK,
                    poll_secs: float = 15.0) -> bool:
    """Block until no live process holds the GPU lock.

    Returns True when the GPU is free; False when ``timeout_secs``
    elapsed with the holder still alive (callers should proceed but tag
    their numbers as contended). Timeout defaults to the
    ``ADAFOCUS_BENCH_WAIT_SECS`` env var, then 1800 s.
    """
    timeout_secs = _timeout(timeout_secs)
    deadline = time.time() + timeout_secs
    warned = False
    while True:
        holder = _holder(path)
        if holder is None:
            if warned:
                print("device_lock: GPU is free, proceeding", flush=True)
            return True
        if time.time() >= deadline:
            print(f"device_lock: TIMEOUT after {timeout_secs:.0f}s — "
                  f"pid {holder[0]} ({holder[1]!r}) still holds the GPU; "
                  "benchmarking anyway, numbers may be contended", flush=True)
            return False
        if not warned:
            print(f"device_lock: GPU held by pid {holder[0]} "
                  f"({holder[1]!r}); waiting up to {timeout_secs:.0f}s "
                  "so the measurement is not polluted by concurrent "
                  "training", flush=True)
            warned = True
        time.sleep(poll_secs)
