"""coder_host_ms: host milliseconds a timestep in the program's
``coder/pack`` and ``coder/parse`` spans, where the v2 containers are
packed and parsed on the host with no device work (``coder/lane_coder.py``).
Read from the program's span totals (``utils/profiling.py::span_totals``),
which count only while a profiler records, so over the traced requests. A
program without span totals, or an untraced run, reads nothing."""

SPANS = ("coder/pack", "coder/parse")


def read(run):
    tr = run.get("trace")
    if tr is None or tr.units == 0:
        return None
    try:
        from cra5_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    totals = span_totals()
    s = sum(totals[name]["s"] for name in SPANS if name in totals)
    if s <= 0:
        return None
    return 1e3 * s / (tr.units * run["batch"])
