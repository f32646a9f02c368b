"""intra_chain_roofline_pct (%, device trace and program counters; kernels
layer): the least time K2's launches in the window need by their
dependency chains (roofline_intra.py: for each launch, the largest
L * c_min + R * h_min over its pictures, summed over the launches) over
the device time of the intra wavefront kernel (intra_wavefront_kernel,
csrc/intra.cu) in the traced window.  None without a K2 launch."""
import devtrace
import roofline_intra


def read(run):
    launched = roofline_intra.launches(run)
    if not launched:
        return None
    t = sum(op.t1 - op.t0 for op in run.ops if op.kind == "kernel" and
            devtrace.kernel_base(op.name) == roofline_intra.KERNEL)
    return roofline_intra.share_pct(launched, t)
