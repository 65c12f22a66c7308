"""Render a ``train_demo_268`` result JSON as Markdown.

Counterpart of ``examples/train_demo_report.py``: the same report, line
for line, but for the line that says where the run came from.

    python -m cra5_tpu_torch.examples.train_demo_report RESULT.json OUT.md

Kept apart from the demo so a finished run can be rendered again without
the card.
"""

from __future__ import annotations

import argparse
import json
import time


def render(result: dict) -> str:
    cfg = result["config"]
    losses = {int(k): v for k, v in result["losses"].items()}
    steps = sorted(losses)
    first, last = losses[steps[0]], losses[steps[-1]]
    s0 = result["codec_step0"]
    tr = result["codec_trained"]
    em = result["codec_trained_ema"]
    res = result["resume"]
    device = result.get("timing", {}).get("device", "the card")

    def row(step):
        m = losses[step]
        return (f"| {step} | {m.get('total_loss', m.get('loss', ''))} "
                f"| {m.get('bpp_loss', '')} | {m.get('mse_loss', '')} "
                f"| {m.get('aux_loss', '')} |")

    # subsample the loss table to ~12 rows
    stride = max(1, len(steps) // 12)
    shown = steps[::stride]
    if steps[-1] not in shown:
        shown.append(steps[-1])

    lines = [
        "# 268v on-chip training demonstration",
        "",
        f"Generated {time.strftime('%Y-%m-%d %H:%M UTC', time.gmtime())} from "
        f"`python -m cra5_tpu_torch.examples.train_demo_268` on {device}: the "
        "PyTorch/CUDA port's training subsystem at the full production geometry "
        "(268×721×1440, ViT-L towers, 10368 tokens) end to end: train → "
        "mid-run checkpoint → restore into a fresh Trainer → continue → "
        "CDF rebuild → compress a held-out field.",
        "",
        f"Config: {cfg['steps']} steps, checkpoint+restore at step "
        f"{cfg['save_at']}, λ={cfg['lmbda']}, bpp_weight={cfg['bpp_weight']}, "
        f"{cfg['pool']} distinct on-device synthetic fields (coarse noise "
        "bilinearly upsampled — spatially correlated like reanalysis data).",
        "",
        "## Loss trajectory",
        "",
        "| step | total | bpp | mse | aux |",
        "|---|---|---|---|---|",
        *[row(s) for s in shown],
        "",
        f"Total loss {first.get('total_loss')} → {last.get('total_loss')}; "
        f"mse {first.get('mse_loss')} → {last.get('mse_loss')}; "
        f"bpp {first.get('bpp_loss')} → {last.get('bpp_loss')}.",
        "",
        "## Mid-run checkpoint / resume (the failure-recovery path)",
        "",
        f"- full-state save (params + adam moments + EMA shadow + step): "
        f"{res['save_s']}s",
        f"- restore into a FRESH Trainer object: {res['restore_s']}s",
        f"- resumed step = {res['resumed_step']}; param/EMA checksums "
        f"verified exact: {res['checksums_match']}",
        "",
        "## Codec before vs after (held-out field)",
        "",
        "| model | bin bytes | bpp | recon MSE |",
        "|---|---|---|---|",
        f"| step-0 (random init) | {s0['bin_bytes']} | {s0['bpp']} | {s0['mse']} |",
        f"| trained | {tr['bin_bytes']} | {tr['bpp']} | {tr['mse']} |",
        f"| trained (EMA shadow) | {em['bin_bytes']} | {em['bpp']} | {em['mse']} |",
        "",
        "Each row is a full `codec.update()` (integer CDF rebuild — the "
        "reference's `update_model` step) + v2 compress → decompress "
        "roundtrip at 721×1440.",
        "",
    ]
    if "timing" in result:
        lines += ["## Timing", "", "```json",
                  json.dumps(result["timing"], indent=1), "```", ""]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("src", help="train_demo_268's result JSON")
    ap.add_argument("dst", help="the Markdown file to write")
    args = ap.parse_args(argv)
    with open(args.src) as f:
        result = json.load(f)
    md = render(result)
    with open(args.dst, "w") as f:
        f.write(md)
    print(f"wrote {args.dst} ({len(md)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
