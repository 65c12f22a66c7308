"""transform_device_ms: device time a timestep launched inside the image
codec's tower stages, ``compress/analysis`` (g_a, h_a), ``compress/hyper``
and ``decompress/hyper`` (h_mean_s, h_scale_s) and
``decompress/synthesis`` (g_s): their convolutions and Swin projections
and MLPs, the window attention inside them left to
``swin_attn_device_ms``."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("_per_timestep", Path(__file__).with_name("_per_timestep.py"))
_pt = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_pt)
STAGES = ("compress/analysis", "compress/hyper", "decompress/hyper", "decompress/synthesis")


def read(run):
    return _pt.device_ms(run, lambda op: op.stage in STAGES)
