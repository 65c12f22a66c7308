"""swin_attn_roofline: the share of its roofline that the window attention
reaches, in percent: the least time of a timestep's attention by the
benchmark's own count from the configuration's shapes
(``benchlib/tcm_count.py::attention_bound_s``: float32 q, k, v read, the
output written and the bias table read, 4 N^2 d operations a window and
head; the larger of the operations over the float32 peak and the bytes
over the memory's) over ``swin_attn_device_ms``."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("_swin_attn", Path(__file__).with_name("swin_attn_device_ms.py"))
_sa = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_sa)


def read(run):
    bound = run.get("attention_bound_s")
    ms = _sa.read(run)
    if not bound or not ms:
        return None
    return 100.0 * 1e3 * bound / ms
