"""Run timing helpers (parity: chiron/utils/unix_time.py:11-26)."""

from __future__ import annotations

import os
import time


def unix_time(function, args=tuple(), kwargs=None):
    """Return dict of real/sys/user seconds consumed by ``function``."""
    if kwargs is None:
        kwargs = {}
    start_time = time.time()
    start_resources = os.times()
    function(*args, **kwargs)
    end_resources = os.times()
    end_time = time.time()
    return {
        "real": end_time - start_time,
        "sys": end_resources.system - start_resources.system,
        "user": end_resources.user - start_resources.user,
    }
