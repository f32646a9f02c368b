"""device_idle_pct (%, device trace; device layer): share of the traced
window in which the card runs neither a kernel nor a copy nor a memset
(the union of the trace's device intervals)."""
import devtrace


def read(run):
    if not run.ops or run.window_s <= 0:
        return None
    busy = devtrace.busy_seconds([(op.t0, op.t1) for op in run.ops],
                                 run.t_start, run.t_end)
    return 100.0 * (1.0 - busy / run.window_s)
