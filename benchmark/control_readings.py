"""The control readings of the cells whose jobs ``readings.py`` does not
dispatch, one JSON line a seed on standard output:

    python3 benchmark/control_readings.py --workload <name> --seeds 11 12 13

``image_roundtrip`` cells: TCM's controls (``benchlib/tcm_controls.py``:
the reference at TF32 and the planted z faults). Each is judged against
the cell's limits; the exit code is 1 where one comes out correct. The program's own readings are
``readings.py --what program``. Not run by the benchmark's own runs.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as _run  # noqa: E402,F401  (the caches and the import path)
from benchlib import harness, judge, tcm_controls  # noqa: E402

CONTROLS = {"image_roundtrip": tcm_controls.codec}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = harness.load_json(harness.HERE.parent / "BENCHMARK.json")
    cell, config, traffic, limits = harness.cell_files(bench, a.workload)
    passed = []
    for seed in a.seeds:
        t = time.perf_counter()
        ctx = harness.Context(cell, config, traffic, torch.device("cuda"), seed, 5.0, False, t,
                              lambda msg: print(f"[readings] {msg}", file=sys.stderr, flush=True),
                              limits)
        out = CONTROLS[traffic["job"]](ctx)
        for name, nums in out.items():
            nums["correct"] = judge.decide(nums, limits)[0]
            if nums["correct"]:
                passed.append(f"{name} (seed {seed})")
        print(json.dumps({"workload": a.workload, "seed": seed, "what": "control", "readings": out,
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    print(f"[readings] loaded {harness.forbidden_modules()}", file=sys.stderr)
    if passed:
        print(f"[readings] came out correct, and must not: {passed}", file=sys.stderr)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
