"""The port's libHMDec C ABI (libhm_tpu_torch/hostdec/native/libhmdec.so)
through ctypes, shared by tests/test_torch_libhmdec.py and chip_smoke.py's
host phase.

- `build()`: make libhmdec.so from the port's native sources, under the
  lock that native_bridge.build() takes in the same directory;
- `load(path)`: the library with the argument and result types of the
  reference surface (libHMDecoder.h) that the decode below calls;
- `decode(lib, data)`: a stream pushed NAL unit by NAL unit through the
  reference protocol (push; push the same unit again when bNewPicture is
  set; drain libHMDec_get_picture when bCheckPicture is set), returning
  the pictures in output order and the library's own MD5 SEI check;
- `md5_of(pics, bitdepth)`: the planes joined in output order at their
  bit depth, as testdata/golden.json's decoded_yuv_md5.
"""
import ctypes as C
import fcntl
import hashlib
import os
import subprocess

import numpy as np

from libhm_tpu_torch.hostdec import nal as N

NATIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "libhm_tpu_torch", "hostdec", "native")


def build_cmd():
    return ["make", "-s", "-C", NATIVE, "libhmdec.so"]


def build():
    with open(os.path.join(NATIVE, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.check_call(build_cmd())
    return os.path.join(NATIVE, "libhmdec.so")


def load(path):
    lib = C.CDLL(path)
    lib.libHMDec_get_version.restype = C.c_char_p
    lib.libHMDec_new_decoder.restype = C.c_void_p
    lib.libHMDec_free_decoder.argtypes = [C.c_void_p]
    lib.libHMDec_set_SEI_Check.argtypes = [C.c_void_p, C.c_bool]
    lib.libHMDec_set_max_temporal_layer.argtypes = [C.c_void_p, C.c_int]
    lib.libHMDec_push_nal_unit.argtypes = [
        C.c_void_p, C.c_char_p, C.c_int, C.c_bool,
        C.POINTER(C.c_bool), C.POINTER(C.c_bool)]
    lib.libHMDec_get_picture.restype = C.c_void_p
    lib.libHMDec_get_picture.argtypes = [C.c_void_p]
    lib.libHMDEC_get_POC.argtypes = [C.c_void_p]
    for fn in ("libHMDEC_get_picture_width", "libHMDEC_get_picture_height",
               "libHMDEC_get_picture_stride"):
        getattr(lib, fn).argtypes = [C.c_void_p, C.c_int]
    lib.libHMDEC_get_image_plane.restype = C.POINTER(C.c_short)
    lib.libHMDEC_get_image_plane.argtypes = [C.c_void_p, C.c_int]
    lib.libHMDEC_get_chroma_format.argtypes = [C.c_void_p]
    lib.libHMDEC_get_hash_ok.argtypes = [C.c_void_p]
    return lib


def _drain(lib, h, pics):
    while True:
        pic = lib.libHMDec_get_picture(C.c_void_p(h))
        if not pic:
            break
        planes = []
        nc = 1 if lib.libHMDEC_get_chroma_format(C.c_void_p(pic)) == 0 else 3
        for comp in range(nc):
            w = lib.libHMDEC_get_picture_width(C.c_void_p(pic), comp)
            hh = lib.libHMDEC_get_picture_height(C.c_void_p(pic), comp)
            stride = lib.libHMDEC_get_picture_stride(C.c_void_p(pic), comp)
            ptr = lib.libHMDEC_get_image_plane(C.c_void_p(pic), comp)
            # short* planes: samples of 2^15 and up come as their 16-bit
            # pattern, read back unsigned
            arr = np.ctypeslib.as_array(ptr, shape=(hh, stride))[:, :w]
            planes.append(arr.view(np.uint16).copy())
        pics.append((lib.libHMDEC_get_POC(C.c_void_p(pic)), planes))


def decode(lib, data):
    """(pictures [(poc, planes)] in output order, libHMDEC_get_hash_ok)."""
    nals = list(N.split_annexb(data))
    h = lib.libHMDec_new_decoder()
    lib.libHMDec_set_SEI_Check(C.c_void_p(h), True)
    pics = []
    new_pic, check = C.c_bool(), C.c_bool()
    for i, ebsp in enumerate(nals):
        eof = i == len(nals) - 1
        for _ in range(2):
            lib.libHMDec_push_nal_unit(C.c_void_p(h), ebsp, len(ebsp), eof,
                                       C.byref(new_pic), C.byref(check))
            if check.value:
                _drain(lib, h, pics)
            if not new_pic.value:
                break       # else push the same NAL unit again
    _drain(lib, h, pics)
    hash_ok = lib.libHMDEC_get_hash_ok(C.c_void_p(h))
    lib.libHMDec_free_decoder(C.c_void_p(h))
    return pics, hash_ok


def md5_of(pics, bitdepth):
    dt = np.uint8 if bitdepth <= 8 else np.uint16
    return hashlib.md5(b"".join(p.astype(dt).tobytes()
                                for _, planes in pics
                                for p in planes)).hexdigest()
