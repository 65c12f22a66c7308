"""swin_attn_device_ms: device time a timestep launched inside the
program's ``swin/attn`` spans: the window attention of every Swin block
between its qkv and output projections (``nn/swin.py``). A program
without the span reads nothing."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("_per_timestep", Path(__file__).with_name("_per_timestep.py"))
_pt = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_pt)
STAGES = ("swin/attn",)


def read(run):
    return _pt.device_ms(run, lambda op: op.stage in STAGES)
