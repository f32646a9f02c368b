"""h2d_mb_per_picture (MB/picture, program counter; transfers layer):
libhm_tpu_torch.utils.xfer.H2D bytes uploaded in the window, in 10^6
bytes, over the pictures delivered."""


def read(run):
    return run.h2d_bytes / 1e6 / run.pictures if run.pictures else None
