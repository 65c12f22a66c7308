"""mfu: the model FLOPs of the timesteps done in the traced run's window
(the benchmark's own count from the configuration's shapes,
``benchlib/flops.py``) over the window's host-clock seconds and the
configuration dtype's peak (``benchlib/peaks.py``), in percent."""


def read(run):
    if not run.get("timesteps") or not run.get("window_s"):
        return None
    return 100.0 * run["flops_per_timestep"] * run["timesteps"] / run["window_s"] / run["peak_flops"]
