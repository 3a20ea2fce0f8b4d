"""Timestamped progress logging and deferred end-of-run messages.

Mirrors the observability behavior of the reference program
(cf. reference .../Common.scala:363-380, DelayedMessages.scala:30-54).
"""

from __future__ import annotations

import sys
import time
from typing import Callable, List

_last_progress_time: float = 0.0


def progress(message: str) -> None:
    """Print a progress message with the time delta since the previous one."""
    global _last_progress_time
    now = time.time()
    if _last_progress_time == 0.0:
        stamp = time.strftime("%a %b %d %H:%M:%S %Y", time.localtime(now))
    else:
        stamp = "%.2f sec. later" % (now - _last_progress_time)
    print("--> [%15s]: %s" % (stamp, message), file=sys.stderr)
    sys.stderr.flush()
    _last_progress_time = now


class DelayedMessages:
    """A queue of message thunks printed after lazy evaluation completes.

    Used for counters whose values are only known after a full pass over the
    data (the reference backs these with Spark accumulators).
    """

    default: "DelayedMessages"

    def __init__(self) -> None:
        self._messages: List[Callable[[], str]] = []

    def say(self, thunk: Callable[[], str]) -> None:
        self._messages.append(thunk)

    def print(self) -> None:
        for thunk in self._messages:
            progress(thunk())
        self._messages = []


DelayedMessages.default = DelayedMessages()
