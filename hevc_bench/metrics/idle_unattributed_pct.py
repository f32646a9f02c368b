"""idle_unattributed_pct (%, device trace and program spans; device
layer): of the time the card idles (devtrace.gaps of the trace's
kernels, copies and memsets) inside the program's `decode` spans in the
window, the share in which the host runs no stage span of the program,
only a grouping one (decode, parse, recon, recon.level): idle time that
no named stage accounts for."""
import program_spans


def read(run):
    return program_spans.idle_unattributed_pct(run)
