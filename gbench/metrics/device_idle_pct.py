"""device_idle_pct: the share of the traced stretch of whole queries in
which no kernel, copy or fill ran on the device: 100 * (1 - the union
of the device's intervals over the stretch's wall)."""


def read(run):
    t = run.trace
    if t is None or not t.device or t.window_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)
