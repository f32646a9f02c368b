# Copied from libhm_tpu/hostdec/fields.py
"""Field-sequence output pairing.

The reference decoder app pairs an even-POC field with the following
odd-POC field and writes one interleaved frame (TAppDecTop.cpp:373-420 ->
TVideoIOYuv::write(top, bottom, ..., isTff)); the top/bottom parity comes
from the picture timing SEI pic_struct (1 = top field, 2 = bottom field,
Rec. D.3.3).  This module reproduces that on DecodedPicture records.
"""
import numpy as np

from .sei import SEI_PIC_TIMING


def pic_struct_of(record):
    """pic_struct from the picture's prefix picture-timing SEI (or None)."""
    for t, payload in (getattr(record, "sei", None) or []):
        if t == SEI_PIC_TIMING:
            return getattr(payload, "pic_struct", None)
    return None


def is_field_stream(records):
    """True when the outputs are field pictures (VUI field_seq_flag or a
    field pic_struct on the first picture)."""
    if not records:
        return False
    r = records[0]
    vui = getattr(r.sps, "vui", None)
    if vui is not None and getattr(vui, "field_seq_flag", 0):
        return True
    return pic_struct_of(r) in (1, 2)


def weave_fields(records):
    """Pair consecutive field pictures into interleaved frames.

    records: DecodedPicture list in output order (POC order).  Returns a
    list of frames, each a list of cropped planes.  A trailing unpaired
    field is dropped, like the reference (it only writes complete pairs).
    """
    frames = []
    for i in range(0, len(records) - 1, 2):
        first, second = records[i], records[i + 1]
        # the even-POC picture is the 'top' positionally; its pic_struct
        # says whether it is displayed as the top (1) or bottom (2) field
        tff = pic_struct_of(first) != 2
        planes = []
        for pt, pb in zip(first.cropped(), second.cropped()):
            f = np.empty((pt.shape[0] * 2, pt.shape[1]), pt.dtype)
            f[0::2] = pt if tff else pb
            f[1::2] = pb if tff else pt
            planes.append(f)
        frames.append(planes)
    return frames
