"""kernel_ms_per_picture (ms/picture, device trace; kernels layer): device
time of the program's own CUDA kernels (the __global__ functions of
libhm_tpu_torch/csrc) in the traced window, over the pictures
delivered.  PyTorch's own kernels and the copies are not counted."""
import devtrace


def read(run):
    t = sum(op.t1 - op.t0 for op in run.ops if op.kind == "kernel" and
            devtrace.kernel_base(op.name) in run.port_kernels)
    return 1e3 * t / run.pictures if run.pictures and t > 0 else None
