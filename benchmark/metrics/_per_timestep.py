"""Device milliseconds a timestep of the operations a predicate picks,
over the traced units (requests or steps) that the profile holds whole.
Shared by the per-layer readers in this folder."""

import json
import re
from pathlib import Path


def patterns(name):
    with open(Path(__file__).with_name(f"{name}.json")) as f:
        return [re.compile(p) for p in json.load(f)["patterns"]]


def device_ms(run, pick):
    tr = run.get("trace")
    if tr is None or tr.units == 0:
        return None
    total = sum(op.dur_s for op in tr.ops if op.unit is not None and pick(op))
    if total <= 0:
        return None
    return 1e3 * total / (tr.units * run["batch"])
