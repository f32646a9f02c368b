"""The program's own spans in a run's window, for the metrics that read
them.

libhm_tpu_torch records a span at each of its host stages, where the
work happens (libhm_tpu_torch/utils/obs.py): a name, a start and an end
on time.perf_counter() (the clock of the window and, through
devtrace.MARK, of the device trace), the span it ran under, and `n`, the
work items it processed.  `recorded` takes the spans of the window; the
functions below reduce them.  Each returns None where the program has no
recorder (a checkout from before it), where its ring pushed out a span
that ended in the window, or where the window holds no span of the
name asked for.
"""
import devtrace

# spans that group stages; every other span is a stage
GROUPING = ("decode", "parse", "recon", "recon.level")


def _obs():
    try:
        from libhm_tpu_torch.utils import obs
    except ImportError:
        return None
    return obs


def recorded(run, before=False):
    """The program's spans with run.t_start <= t0 and t1 <= run.t_end, or
    with before=True those that closed before the window; None where the
    program records none or lost one that ended in the window."""
    obs = _obs()
    if obs is None:
        return None
    every = obs.spans()
    # the ring drops its oldest entries first: where it dropped any, the
    # oldest left has to have ended before the window
    if obs.dropped and (not every or every[0].t1 >= run.t_start):
        return None
    if before:
        return [s for s in every if s.t1 <= run.t_start]
    return [s for s in every if s.t0 >= run.t_start and s.t1 <= run.t_end]


def intersect(a, b):
    """The intersection of two sorted, disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(intervals):
    return sum(b - a for a, b in intervals)


def self_seconds(spans, name):
    """Summed self time of the spans called `name`: each one's duration
    less the union of its children's intervals."""
    children = {}
    for s in spans:
        children.setdefault(s.parent, []).append((s.t0, s.t1))
    return sum(s.t1 - s.t0 - length(intersect(
        devtrace.union(children.get(s.id, [])), [(s.t0, s.t1)]))
        for s in spans if s.name == name)


def ms_per_picture(run, name):
    """Summed duration of the window's `name` spans, in ms, over the
    pictures delivered."""
    spans = recorded(run)
    if not spans or not run.pictures:
        return None
    mine = [s for s in spans if s.name == name]
    if not mine:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in mine) / run.pictures


def us_per_item(run, name):
    """Self time of the window's `name` spans, in us, over the items
    their `n` counts."""
    spans = recorded(run)
    if not spans:
        return None
    items = sum(s.n for s in spans if s.name == name)
    if not items:
        return None
    return 1e6 * self_seconds(spans, name) / items


def seconds_before(run, name):
    """Summed duration of the `name` spans that closed before the
    window."""
    spans = recorded(run, before=True)
    mine = [s for s in spans or [] if s.name == name]
    return sum(s.t1 - s.t0 for s in mine) if mine else None


def idle_unattributed_pct(run):
    """Of the device-idle time inside the window's `decode` spans, the
    share in which no stage span is open (on any thread): the host is in
    a grouping span's own code."""
    spans = recorded(run)
    if not spans or not run.ops:
        return None
    idle = devtrace.gaps([(op.t0, op.t1) for op in run.ops], run.t_start,
                         run.t_end)
    calls = devtrace.union([(s.t0, s.t1) for s in spans
                            if s.name == "decode"])
    inside = intersect(idle, calls)
    total = length(inside)
    if total <= 0:
        return None
    stages = devtrace.union([(s.t0, s.t1) for s in spans
                             if s.name not in GROUPING])
    return 100.0 * (total - length(intersect(inside, stages))) / total
