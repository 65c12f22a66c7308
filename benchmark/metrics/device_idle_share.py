"""device_idle_share: the share of the traced window in which no device
operation ran on any stream (``benchlib/trace.py``), in percent."""


def read(run):
    tr = run.get("trace")
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
