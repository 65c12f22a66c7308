"""RD-curve plotting from eval/bench result JSONs.

Counterpart of ``cra5_tpu/tools/plot.py``: each input JSON has {"name",
"results": {"bpp": [...], "<metric>": [...]}}; points are sorted by rate
and drawn as one curve per file.

The published RD anchors (VIVT-69, VIVT-138, JPEG-2000 and the CompressAI
curves) are kept as data under ``plot_data/``, a copy of the JAX
package's; pass their bare names to -f (e.g. ``-f VIVT-69 myrun.json``).
Those anchors key the rate axis as "bpsp", so the rate key is
auto-detected (bpp, else bpsp) unless --rate-key is given. matplotlib is
imported inside ``main``; nothing else of the port needs it.

Usage:
  python -m cra5_tpu_torch.tools.plot -f a.json b.json --metric psnr-rgb -o rd.png
  python -m cra5_tpu_torch.tools.plot -f VIVT-69 VIVT-138 --metric MSE -o rd.png
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ANCHOR_DIR = Path(__file__).parent / "plot_data"


def list_anchors():
    return sorted(p.stem for p in ANCHOR_DIR.glob("*.json"))


def resolve_result_path(name: str) -> Path:
    """A results file path, or the bare name of a vendored anchor."""
    p = Path(name)
    if p.exists():
        return p
    anchor = ANCHOR_DIR / f"{Path(name).stem}.json"
    if anchor.exists():
        return anchor
    raise FileNotFoundError(
        f"{name}: not a file and not a vendored anchor (have: {', '.join(list_anchors())})"
    )


def load_result(path: str):
    data = json.loads(resolve_result_path(path).read_text())
    if "results" not in data:
        raise ValueError(f"{path}: missing 'results'")
    return data


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-f", "--results-file", nargs="+", required=True)
    parser.add_argument("--metric", default="psnr-rgb")
    parser.add_argument("--rate-key", default=None,
                        help="rate axis key (default: bpp, else bpsp)")
    parser.add_argument("--title", default="RD curves")
    parser.add_argument("-o", "--output", default=None, help="save to file instead of showing")
    args = parser.parse_args(argv)

    import matplotlib

    if args.output:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(9, 6))
    xlabel = args.rate_key or "bpp"
    for path in args.results_file:
        data = load_result(path)
        results = data["results"]
        if args.metric not in results:
            print(f"{path}: metric '{args.metric}' not in {sorted(results)}", file=sys.stderr)
            return 1
        rate_key = args.rate_key or ("bpp" if "bpp" in results else "bpsp")
        if rate_key not in results:
            print(f"{path}: rate key '{rate_key}' not in {sorted(results)}", file=sys.stderr)
            return 1
        xlabel = rate_key
        pts = sorted(zip(results[rate_key], results[args.metric]))
        ax.plot(
            [p[0] for p in pts],
            [p[1] for p in pts],
            marker="o",
            label=data.get("name", Path(path).stem),
        )
    ax.set_xlabel(xlabel)
    ax.set_ylabel(args.metric)
    ax.set_title(args.title)
    ax.grid(True, alpha=0.3)
    ax.legend()
    if args.output:
        fig.savefig(args.output, dpi=150, bbox_inches="tight")
        print(f"saved {args.output}")
    else:
        plt.show()
    return 0


if __name__ == "__main__":
    sys.exit(main())
