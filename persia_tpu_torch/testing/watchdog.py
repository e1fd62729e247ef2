"""A watchdog for calls that start threads (the cache tier's stream): a
call that does not return within its time fails, with every thread's stack
printed, instead of hanging the test run."""

from __future__ import annotations

import faulthandler
import sys
import threading
from typing import Callable, TypeVar

T = TypeVar("T")


def run_with_watchdog(fn: Callable[[], T], timeout: float = 60.0, what: str = "the call") -> T:
    """``fn()`` on a daemon thread, joined for at most ``timeout`` seconds:
    its result, or its exception raised again here. On timeout every
    thread's stack goes to stderr and ``TimeoutError`` is raised."""
    if timeout > 60.0:
        raise ValueError(f"a watchdog waits at most 60 s, not {timeout}")
    out = {}

    def body():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — raised again by the caller
            out["error"] = e

    t = threading.Thread(target=body, name="watchdog-call", daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        raise TimeoutError(f"{what} did not return within {timeout:g} s (every thread's stack is above)")
    if "error" in out:
        raise out["error"]
    return out["value"]
