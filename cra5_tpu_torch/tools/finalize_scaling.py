"""Host-finalize concurrency microbench.

Counterpart of ``cra5_tpu/tools/finalize_scaling.py``. A serving host
that feeds several cards does each sample's host finalize work for all of
them: the v2 container assembly (buffer slicing, escape varints, header
pack, byte join) and, on the decode side, the container parse (header
validation, the ``frombuffer`` copies, varint decode). This
tool measures that work on recorded streams; the replay needs no card.

Two phases:

  record   run ONE compress (entropy side calibrated unless
           --no-calibrate, reusing the bench's calibration cache) and
           save its containers, z streams then y, with the host arrays
           ``coder/lane_coder.py::assemble_container`` packs each from (read
           back from the container by ``parse_v2_header`` and
           ``container_arrays``: on the card K9 writes the containers and the
           host packs nothing), into an .npz.
           ``--model 268`` on the card lands the bench's field (``--amp``
           or ``--target-bytes`` move the bin size); ``--model tiny
           --device cpu`` serves the tests.

  replay   load the .npz and drive N host threads, each looping the
           port's host code over the recorded inputs:
           ``assemble_container`` for the encode side and, with
           ``--parse``, ``host_parse`` for the decode side. Threads, as in
           production (``tools/serve.py`` decodes on a thread pool in one
           process). A replayed container must equal the recorded one
           byte for byte. Prints aggregate samples/s by thread count.

Usage:
  python -m cra5_tpu_torch.tools.finalize_scaling record -o fin.npz [--model 268|tiny]
      [--device cuda|cpu] [--amp A | --target-bytes B] [--no-calibrate]
  python -m cra5_tpu_torch.tools.finalize_scaling replay fin.npz [--workers 1,2,4,8]
      [--seconds S] [--parse] [--required-rps R]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_FIELDS = ("n", "K", "nw", "ne", "sorted", "safe", "states", "stream", "escs", "container")


def _record(args) -> int:
    import torch

    from .. import bench
    from ..coder import lane_coder

    s = bench.setup(args.device, args.model, torch.bfloat16, calibrate=args.calibrate)
    codec, x = s.codec, s.x
    amp = args.amp
    if args.target_bytes:
        # the bench production point's secant in log amplitude: stream
        # bytes grow ~log with the amplitude
        for _ in range(6):
            out = codec.compress(x * amp)
            nb = float(sum(len(grp[0]) for grp in out["strings"]))
            print(json.dumps({"amp_probe": round(amp, 3), "bin_bytes": int(nb)}),
                  file=sys.stderr, flush=True)
            if abs(nb - args.target_bytes) / args.target_bytes < 0.08:
                break
            new_amp = min(amp * min((args.target_bytes / nb) ** 0.8, 4.0), 16.0)
            if new_amp == amp:
                break
            amp = new_amp
    if amp != 1.0:
        x = x * amp

    out = codec.compress(x)
    recorded = []
    for data in [*out["strings"][1], *out["strings"][0]]:  # the order the codec packs them
        hdr = lane_coder.parse_v2_header(data)
        n, K, ne, nw, srt, safe, _ = hdr
        states, stream, escs = lane_coder.container_arrays(data, hdr)
        recorded.append(dict(
            n=n, K=K, nw=nw, ne=ne, sorted=int(srt), safe=int(safe),
            states=states.view(np.uint32), stream=stream.view(np.uint16), escs=escs,
            container=np.frombuffer(data, np.uint8)))
    total = sum(len(grp[0]) for grp in out["strings"])
    payload = {"n_streams": np.int64(len(recorded)), "bin_bytes": np.int64(total),
               "amp": np.float64(amp)}
    for i, r in enumerate(recorded):
        for k, v in r.items():
            payload[f"s{i}_{k}"] = v
    np.savez_compressed(args.out, **payload)
    print(json.dumps({
        "recorded_streams": len(recorded),
        "bin_bytes": total,
        "stream_sizes": [int(r["container"].size) for r in recorded],
        "amp": round(float(amp), 3),
        "device": s.card,
        "out": args.out,
    }))
    return 0


def load_recording(path: str) -> list:
    """The recorded streams of an .npz, one dict each (``_FIELDS``)."""
    z = np.load(path)
    streams = []
    for i in range(int(z["n_streams"])):
        s = {k: z[f"s{i}_{k}"] for k in _FIELDS}
        streams.append(dict(
            n=int(s["n"]), K=int(s["K"]), nw=int(s["nw"]), ne=int(s["ne"]),
            sorted=bool(int(s["sorted"])), safe=bool(int(s["safe"])),
            states=s["states"], stream=s["stream"], escs=s["escs"],
            container=s["container"].tobytes()))
    return streams


def host_parse(datas) -> list:
    """The decode side's host work on containers, as the port's
    ``LaneCoder.upload_batch`` does it up to the copy to the card: each
    header validated and its states, words and escapes read
    (``lane_coder.container_arrays``, which ``_upload`` calls). One
    (states, stream, escs) tuple a container."""
    from ..coder.lane_coder import container_arrays, parse_v2_header

    return [container_arrays(d, parse_v2_header(d)) for d in datas]


def _assemble(s) -> bytes:
    from ..coder.lane_coder import assemble_container

    return assemble_container(s["n"], s["K"], s["nw"], s["ne"], s["sorted"], s["safe"],
                              s["states"], s["stream"], s["escs"])


def _sweep(fn, workers, seconds: float) -> dict:
    """Aggregate calls of ``fn`` a second on a pool of each size."""
    rates = {}
    for n_workers in workers:
        pool = ThreadPoolExecutor(n_workers)
        try:
            list(pool.map(lambda _: fn(), range(2 * n_workers)))  # warm
            stop_at = time.time() + seconds
            done = 0
            futs = [pool.submit(fn) for _ in range(4 * n_workers)]
            t0 = time.time()
            while True:
                for f in futs:
                    f.result()
                done += len(futs)
                if time.time() >= stop_at:
                    break
                futs = [pool.submit(fn) for _ in range(4 * n_workers)]
            rates[n_workers] = done / (time.time() - t0)
        finally:
            pool.shutdown()
    return rates


def _replay(args) -> int:
    streams = load_recording(args.npz)
    # the replayed assembly reproduces the recorded bytes
    for i, s in enumerate(streams):
        if _assemble(s) != s["container"]:
            raise SystemExit(f"stream {i}: the replayed container differs from the recording")

    def one_sample_encode():
        for s in streams:
            _assemble(s)

    datas = [s["container"] for s in streams]

    def one_sample_parse():
        host_parse(datas)

    bin_bytes = int(np.load(args.npz)["bin_bytes"])
    enc = _sweep(one_sample_encode, args.workers, args.seconds)
    result = {
        "metric": "host_finalize_samples_per_sec",
        "bin_bytes": bin_bytes,
        "streams_per_sample": len(streams),
        "encode_finalize": {str(k): round(v, 2) for k, v in enc.items()},
        "encode_ms_1thread": round(1000.0 / enc[args.workers[0]], 3),
    }
    if args.parse:
        par = _sweep(one_sample_parse, args.workers, args.seconds)
        result["decode_parse"] = {str(k): round(v, 2) for k, v in par.items()}
        result["parse_ms_1thread"] = round(1000.0 / par[args.workers[0]], 3)
    if args.required_rps:
        result["required_rps"] = args.required_rps
        result["encode_headroom_x"] = round(max(enc.values()) / args.required_rps, 2)
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("record", help="capture finalize inputs from one compress")
    pr.add_argument("-o", "--out", required=True)
    pr.add_argument("--model", choices=["268", "tiny"], default="268")
    pr.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu; the card unless asked")
    pr.add_argument("--amp", type=float, default=1.0,
                    help="input amplitude (scale until the bin reaches a production size)")
    pr.add_argument("--target-bytes", type=float, default=None,
                    help="amplitude search (from --amp) until the bin lands within "
                         "8%% of this size, as the bench's production point")
    pr.add_argument("--no-calibrate", dest="calibrate", action="store_false")
    pp = sub.add_parser("replay", help="thread-scaling sweep over a recording")
    pp.add_argument("npz")
    pp.add_argument("--workers", type=lambda s: [int(x) for x in s.split(",")],
                    default=[1, 2, 4, 6, 8, 12])
    pp.add_argument("--seconds", type=float, default=3.0,
                    help="measurement window per worker count")
    pp.add_argument("--parse", action="store_true",
                    help="also sweep the decode side's host container parse")
    pp.add_argument("--required-rps", type=float, default=None,
                    help="aggregate samples/s the serving host needs")
    args = p.parse_args(argv)
    return _record(args) if args.cmd == "record" else _replay(args)


if __name__ == "__main__":
    sys.exit(main())
