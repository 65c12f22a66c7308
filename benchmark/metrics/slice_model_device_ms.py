"""slice_model_device_ms: device time a timestep launched inside the
program's ``charm/params`` and ``charm/lrp`` spans: each slice's SWAtten
gates, cc transforms and latent residual prediction, both ways
(``models/stf2022.py::CharmCodec``), the attention inside them left to
``swin_attn_device_ms``. A program without the spans reads nothing."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("_per_timestep", Path(__file__).with_name("_per_timestep.py"))
_pt = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_pt)
STAGES = ("charm/params", "charm/lrp")


def read(run):
    return _pt.device_ms(run, lambda op: op.stage in STAGES)
