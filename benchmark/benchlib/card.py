"""The card's clocks, temperature, power and throttle reasons, read
beside each measured window (before, midway and after), and the process's
CPU seconds over it, so that a drift between runs can be told apart from
the program's own. Logged to standard error; no metric reads them."""

from __future__ import annotations

import os
import subprocess

_QUERY = "clocks.sm,clocks.mem,temperature.gpu,power.draw,power.limit,clocks_event_reasons.active"


def sample(index: int = 0) -> str:
    try:
        r = subprocess.run(["nvidia-smi", f"--id={index}", f"--query-gpu={_QUERY}",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        gpu = r.stdout.strip() if r.returncode == 0 and r.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        gpu = "not read"
    return f"card [{gpu}] (sm MHz, mem MHz, C, W, limit, reasons)"


def cpu_s() -> float:
    """This process's user and system CPU seconds so far."""
    t = os.times()
    return t.user + t.system
