"""The comparison that decides `correct`: every file the timed path
delivered against what HM decoded from the same stream.

The reference is HM's own decode, made outside the program: the MD5 of the
YUV file that HM's TAppDecoder wrote from the configuration's stream
(16-bit little-endian samples above 8 bits, output order,
conformance-cropped), with its picture count.  Nothing of the program is
read to make it.  A delivered file is the list of pictures one call (one
opening, one stream of decode_streams) returned; each picture's planes
must have the configuration's geometry and sample type, and the MD5 of
their bytes in order must equal HM's.  Both numbers compared are counts
with the limit 0: an exact comparison.

The control (`to_8_bits`) is the decode at the nearest precision below the
configuration's 10 bits: every sample rounded to 8 bits and shifted back,
as an 8-bit output path would deliver it.  It has to fail.
"""
import hashlib

import numpy as np

LIMITS = {"files_wrong": 0, "pictures_missing": 0}


def plane_shapes(geometry):
    """(height, width) of each plane of a cropped picture."""
    w, h = geometry["width"], geometry["height"]
    fmt = geometry["chroma_format"]
    if fmt == "400":
        return [(h, w)]
    sx = 2 if fmt in ("420", "422") else 1
    sy = 2 if fmt == "420" else 1
    return [(h, w), (h // sy, w // sx), (h // sy, w // sx)]


def sample_dtype(geometry):
    return np.dtype("<u2") if geometry["bit_depth"] > 8 else np.dtype("u1")


def file_md5(pictures, geometry, transform=None):
    """MD5 of a file's pictures as HM writes them, or None when a plane
    has another shape or sample type than the configuration's."""
    shapes = plane_shapes(geometry)
    dtype = sample_dtype(geometry)
    h = hashlib.md5()
    for pic in pictures:
        if len(pic) != len(shapes):
            return None
        for plane, shape in zip(pic, shapes):
            a = np.asarray(plane)
            if a.shape != shape or a.dtype.newbyteorder("<") != dtype:
                return None
            if transform is not None:
                a = transform(a, geometry["bit_depth"])
            h.update(np.ascontiguousarray(a, dtype=dtype).tobytes())
    return h.hexdigest()


def to_8_bits(a, bit_depth):
    """Samples rounded to 8 bits and shifted back to `bit_depth` bits."""
    s = bit_depth - 8
    q = np.minimum((a.astype(np.int32) + (1 << (s - 1))) >> s, 255)
    return (q << s).astype(a.dtype)


def compare(files, reference, geometry, transform=None):
    """The numbers compared, over every delivered file."""
    wrong = missing = 0
    for pictures in files:
        md5 = file_md5(pictures, geometry, transform)
        if md5 != reference["decoded_yuv_md5"]:
            wrong += 1
        missing += max(0, reference["frames"] - len(pictures))
    return {"files_wrong": wrong, "pictures_missing": missing}


def within_limits(numbers):
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)
