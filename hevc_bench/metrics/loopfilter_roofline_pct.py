"""loopfilter_roofline_pct (%, device trace; kernels layer): the bytes the
in-loop filters need for the pictures delivered (roofline.py: every
sample of every plane read once and written once) at the card's published
bandwidth, over the device time of the loop-filter kernel
(loop_filter_kernel, csrc/loopfilter.cu) in the traced window."""
import devtrace
import roofline

KERNEL = "loop_filter_kernel"


def read(run):
    t = sum(op.t1 - op.t0 for op in run.ops if op.kind == "kernel" and
            devtrace.kernel_base(op.name) == KERNEL)
    nbytes = roofline.loop_filter_bytes(run.config["geometry"], run.pictures)
    return roofline.share_pct(nbytes, t, run.device_name)
