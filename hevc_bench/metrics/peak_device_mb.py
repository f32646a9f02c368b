"""peak_device_mb (MB, program counter; device layer):
torch.cuda.max_memory_allocated() over the window, reset at its start, in
10^6 bytes."""


def read(run):
    return run.peak_window_bytes / 1e6 if run.peak_window_bytes else None
