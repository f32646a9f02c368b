"""The yardstick of the kernels' roofline shares: published peaks of the
card, and the bytes a kernel's work needs, counted from the picture
geometry and never from the implementation's own tensors, so that a
redesign that changes a layout does not change the count.
"""
from reference import plane_shapes

# NVIDIA H100 data sheet (SXM part): 80 GB of HBM3 at 3.35 TB/s.  Keyed by
# torch.cuda.get_device_name(); a card not listed gets no roofline share.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def sample_bytes(bit_depth):
    return 1 if bit_depth <= 8 else 2


def loop_filter_bytes(geometry, pictures):
    """Bytes the in-loop filters (deblocking and SAO of every plane) need
    for `pictures` pictures: every sample of every plane read once and
    written once, at the sample's size (2 bytes above 8 bits)."""
    samples = sum(h * w for h, w in plane_shapes(geometry))
    return pictures * samples * sample_bytes(geometry["bit_depth"]) * 2


def share_pct(nbytes, seconds, device_name):
    """Percent of the byte roofline: the least time at the card's
    published bandwidth over the measured time; None without a time or a
    published peak."""
    peak = PEAKS.get(device_name, {}).get("hbm_bytes_per_s")
    if not peak or seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / (peak * seconds)
