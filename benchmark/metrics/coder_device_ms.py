"""coder_device_ms: device time a timestep launched inside the codec's
coder ranges: ``compress/encode_z``, ``encode_y``, ``finalize`` and
``decompress/upload_y``, ``decode_z``, ``decode_y`` (K1-K3 and the index,
sort and compaction work around them)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("_per_timestep", Path(__file__).with_name("_per_timestep.py"))
_pt = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_pt)
STAGES = ("compress/encode_z", "compress/encode_y", "compress/finalize",
          "decompress/upload_y", "decompress/decode_z", "decompress/decode_y")


def read(run):
    return _pt.device_ms(run, lambda op: op.stage in STAGES)
