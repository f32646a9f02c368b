"""The yardstick of K2's chain roofline share (intra_chain_roofline_pct):
the least time the intra wavefront needs by its dependency chain, from
the chain terms the program records for each launch, never from the
kernel's own design.

A launch reconstructs one component of one or more pictures.  A picture
whose blocks fall into L dependency levels, and whose chain crosses R
hand-overs between CTU rows (rows whose row above also holds intra
blocks), takes at least L * C_MIN_US + R * H_MIN_US; its pictures are
independent, so a launch takes at least the largest of its pictures'.

- C_MIN_US: a level inside one SM: four dependent shared-memory loads
  (28 cycles each, clock64 marks on an H100) and two CTA barriers, at
  1.98 GHz.
- H_MIN_US: a hand-over between SMs: two L2 round trips (a release, then
  an acquire that sees it; 0.1423 us each, csrc/probe.cu on an H100).

The program's counts (libhm_tpu_torch/utils/obs.py, ops/intra.py): each
K2 call is a span "k2" whose n is its blocks, holding the counts
"k2.lattice" (columns of the shared-memory lattice; CUDA launches only),
"k2.plane_blocks" and, per picture in order, "k2.levels" then
"k2.handovers".
"""
import program_spans

C_MIN_US = 0.087
H_MIN_US = 0.285
KERNEL = "intra_wavefront_kernel"


def launches(run):
    """The K2 launches of the run's window, in order: {"blocks",
    "plane_blocks", "lattice" (None on the CPU), "chain": [(L, R)]}; None
    where the program records no spans (program_spans.recorded)."""
    spans = program_spans.recorded(run)
    if spans is None:
        return None
    counts = {}
    for s in spans:
        if s.name.startswith("k2."):
            counts.setdefault(s.parent, []).append(s)
    out = []
    for s in spans:
        if s.name != "k2":
            continue
        mine = sorted(counts.get(s.id, []), key=lambda c: c.id)

        def of(name):
            return [c.n for c in mine if c.name == name]
        lattice = of("k2.lattice")
        out.append({"blocks": s.n, "plane_blocks": sum(of("k2.plane_blocks")),
                    "lattice": lattice[0] if lattice else None,
                    "chain": list(zip(of("k2.levels"), of("k2.handovers")))})
    return out


def launch_bound_us(chain):
    """The least time of one launch whose pictures have the chain terms
    `chain` [(L, R)], in us."""
    return max((L * C_MIN_US + R * H_MIN_US for L, R in chain), default=0.0)


def share_pct(launched, seconds):
    """Percent of the chain roofline: the launches' summed bounds over
    the kernel's measured time; None without a launch, a bound or a
    time."""
    bound_s = 1e-6 * sum(launch_bound_us(k["chain"]) for k in launched or [])
    if seconds <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / seconds
