"""PyTorch/CUDA port of the libhm_tpu device decode path.

`libhm_tpu` (JAX) stays the reference; this package mirrors its module
names so each counterpart is easy to find:

    parallel/dag_decode.py      decode_batch / decode_batch_device entry
                                points (reference-DAG levels, inter + intra)
    parallel/batch_decode.py    residual planes + batched intra wavefront
    parallel/device_filters.py  deblocking V/H + SAO per level
    parallel/intra_wavefront.py host levelization of intra blocks
    ops/{transform,intra,deblock,sao,interp,checksum}.py
                                plain torch versions + kernel wrappers
    csrc/*.cu                   hand-written Hopper (sm_90a) kernels
    kernels/build.py            nvcc build + ctypes binding of csrc/
    hostdec/                    the host half (Annex-B/CABAC parse in native
                                C++, control plane, boundary-strength maps):
                                a copy of libhm_tpu/hostdec, one file each

Nothing in this package imports JAX or the JAX package, directly or
indirectly.  The entry points run on the card (device="cuda") unless the
caller asks for the CPU.

Each kernel wrapper runs its plain torch version for a CPU tensor and
launches its CUDA kernel for a CUDA tensor; there is no fallback between
the two.
"""
