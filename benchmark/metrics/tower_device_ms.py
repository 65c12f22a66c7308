"""tower_device_ms: device time a timestep launched inside the codec's
``compress/g_a`` and ``decompress/g_s`` ranges (the towers with the 1x1
projections)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("_per_timestep", Path(__file__).with_name("_per_timestep.py"))
_pt = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_pt)
STAGES = ("compress/g_a", "decompress/g_s")


def read(run):
    return _pt.device_ms(run, lambda op: op.stage in STAGES)
