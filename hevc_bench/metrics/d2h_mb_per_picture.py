"""d2h_mb_per_picture (MB/picture, program counter; transfers layer):
libhm_tpu_torch.utils.xfer.D2H bytes downloaded in the window, in 10^6
bytes, over the pictures delivered."""


def read(run):
    return run.d2h_bytes / 1e6 / run.pictures if run.pictures else None
