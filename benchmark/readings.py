"""The readings that the correctness limits are set from, one JSON line a
seed on standard output.

    python3 benchmark/readings.py --workload <name> --seeds 11 12 13 --what program|control [--seconds 5]

``program``: the benchmark's own run of the cell, at a short window, in one
process for all seeds; its checks are the program's readings. ``control``:
the reference one precision below the configuration's in the program's
place, and the planted faults (``benchlib/controls.py``), each judged
against the cell's limits (``judge.decide``): the exit code is 1 where a
control or a fault comes out correct. Not run by the benchmark's own runs.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as _run  # noqa: E402,F401  (the caches and the import path)
from benchlib import controls, harness, judge  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--what", choices=("program", "control"), required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    a = p.parse_args(argv)
    import torch

    bench = harness.load_json(harness.HERE.parent / "BENCHMARK.json")
    cell, config, traffic, limits = harness.cell_files(bench, a.workload)
    passed = []
    for seed in a.seeds:
        t = time.perf_counter()
        if a.what == "program":
            line = harness.run(a.workload, seed, a.seconds, False, t)
            out = {k: v["value"] for k, v in line["checks"].items()}
            out["correct"] = line["correct"]
        else:
            ctx = harness.Context(cell, config, traffic, torch.device("cuda"), seed, a.seconds,
                                  False, t, lambda msg: print(f"[readings] {msg}", file=sys.stderr,
                                                              flush=True), limits)
            out = (controls.codec(ctx) if traffic["job"] == "roundtrip"
                   else controls.training(ctx))
            for name, nums in out.items():
                nums["correct"] = judge.decide(nums, limits)[0]
                if nums["correct"]:
                    passed.append(f"{name} (seed {seed})")
        print(json.dumps({"workload": a.workload, "seed": seed, "what": a.what, "readings": out,
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    print(f"[readings] loaded {harness.forbidden_modules()}", file=sys.stderr)
    if passed:
        print(f"[readings] came out correct, and must not: {passed}", file=sys.stderr)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
