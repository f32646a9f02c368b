# Copied from libhm_tpu/hostdec/native_bridge.py
"""ctypes bridge to the native host parser (libhevcdec.so).

Parses a whole Annex-B stream in C++ and materialises the same PicSyntax
objects the Python parser produces, so the reconstruction backends (numpy
oracle or TPU) are shared between both parse planes.
"""
import ctypes as C
import os
import subprocess

import numpy as np

from .picture import PicSyntax, TransformUnit, IntraBlock, InterPU
from . import params as hls
from ..utils import obs

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
_LIB = None


def _pick_variant(so_v3):
    """Prefer the AVX-512 build when this host actually runs it faster.

    Virtualized hosts disagree wildly (one ran 512-bit code 8x slower than
    AVX2, another 8% faster), so the choice is measured: each variant's
    hevcdec_simd_probe (the 8-tap MC filter hot loop) is timed in a tiny
    subprocess (python -I -S: no site/jax import) and the faster library
    wins.  Any failure falls back to the portable AVX2 build.
    """
    so_v4 = os.path.join(_DIR, "libhevcdec_v4.so")
    if not os.path.exists(so_v4):
        return so_v3
    try:
        if "avx512bw" not in open("/proc/cpuinfo").read():
            return so_v3
        import sys
        snippet = ("import ctypes,sys;lib=ctypes.CDLL(sys.argv[1]);"
                   "lib.hevcdec_simd_probe.restype=ctypes.c_double;"
                   "lib.hevcdec_simd_probe(2000);"
                   "print(min(lib.hevcdec_simd_probe(20000) "
                   "for _ in range(3)))")
        t = {}
        for so in (so_v3, so_v4):
            r = subprocess.run([sys.executable, "-I", "-S", "-c", snippet,
                                so], capture_output=True, text=True,
                               timeout=60)
            if r.returncode != 0:
                return so_v3
            t[so] = float(r.stdout.strip())
        return so_v4 if t[so_v4] < t[so_v3] else so_v3
    except Exception:
        return so_v3


def build():
    """Build the parser libraries (not the libHMDec C ABI) when a source
    is newer; returns the path of libhevcdec.so.  A file lock serialises
    concurrent first uses (test workers) so none loads a half-written
    library."""
    import fcntl
    so = os.path.join(_DIR, "libhevcdec.so")
    with open(os.path.join(_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(so) or any(
                os.path.getmtime(os.path.join(_DIR, f)) > os.path.getmtime(so)
                for f in os.listdir(_DIR) if f.endswith((".cpp", ".h"))):
            subprocess.check_call(["make", "-s", "-j2", "-C", _DIR,
                                   "libhevcdec.so", "libhevcdec_v4.so"])
    return so


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    with obs.span("parser.load"):
        so = build()
        lib = C.CDLL(_pick_variant(so))
    lib.hevcdec_create.restype = C.c_void_p
    lib.hevcdec_decode.argtypes = [C.c_void_p, C.c_char_p, C.c_size_t]
    lib.hevcdec_feed.argtypes = [C.c_void_p, C.c_char_p, C.c_size_t]
    lib.hevcdec_flush.argtypes = [C.c_void_p]
    lib.hevcdec_plane_size.restype = C.c_int
    lib.hevcdec_plane_size.argtypes = [C.c_void_p, C.c_int, C.c_int]
    # encoder search kernels (encsearch.cpp)
    lib.enc_satd.restype = C.c_longlong
    lib.enc_satd.argtypes = [C.c_void_p, C.c_void_p, C.c_int, C.c_int]
    lib.enc_satd32.restype = C.c_longlong
    lib.enc_satd32.argtypes = [C.c_void_p, C.c_void_p, C.c_int, C.c_int]
    lib.enc_me_search.argtypes = [
        C.c_void_p, C.c_int, C.c_int, C.c_int, C.c_void_p,
        C.c_int, C.c_int, C.c_int, C.c_int, C.c_int, C.c_int, C.c_int,
        C.c_double, C.c_int, C.c_int, C.c_int, C.c_void_p]
    lib.enc_bi_refine.argtypes = [
        C.c_void_p, C.c_int, C.c_int, C.c_int, C.c_void_p,
        C.c_int, C.c_int, C.c_int, C.c_int, C.c_int, C.c_int, C.c_int,
        C.c_double, C.c_int, C.c_int, C.c_int, C.c_int, C.c_void_p]
    lib.enc_interp_luma.argtypes = [
        C.c_void_p, C.c_int, C.c_int, C.c_longlong,
        C.c_int, C.c_int, C.c_int, C.c_int, C.c_int, C.c_int,
        C.c_int, C.c_int, C.c_void_p]
    # their int32 forms, exact at 8-16 bits (the int16 ones up to 12)
    lib.enc_me_search32.argtypes = lib.enc_me_search.argtypes
    lib.enc_bi_refine32.argtypes = lib.enc_bi_refine.argtypes
    lib.enc_interp_luma32.argtypes = lib.enc_interp_luma.argtypes
    lib.enc_residual_bits.restype = C.c_double
    lib.enc_residual_bits.argtypes = [
        C.c_void_p, C.c_int, C.c_int, C.c_int, C.c_int, C.c_int, C.c_int,
        C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p,
        C.c_void_p, C.c_void_p, C.c_double]
    lib.enc_rdoq.argtypes = [
        C.c_void_p, C.c_int, C.c_int, C.c_int, C.c_int, C.c_int,
        C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p,
        C.c_void_p, C.c_double, C.c_int, C.c_void_p]
    lib.enc_tu_fwd.restype = C.c_int
    lib.enc_tu_fwd.argtypes = [
        C.c_void_p, C.c_int, C.c_int, C.c_int, C.c_int, C.c_int, C.c_int,
        C.c_int, C.c_int, C.c_double, C.c_int, C.c_int, C.c_double,
        C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p,
        C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p]
    # native CTU compressor (encctu.cpp)
    lib.enc_ctu_create.restype = C.c_void_p
    lib.enc_ctu_create.argtypes = [C.c_void_p, C.c_void_p, C.c_void_p,
                                   C.c_void_p]
    lib.enc_ctu_destroy.argtypes = [C.c_void_p]
    lib.enc_ctu_compress.restype = C.c_longlong
    lib.enc_ctu_compress.argtypes = [C.c_void_p, C.c_int, C.c_int]
    lib.enc_ctu_fetch_ops.argtypes = [C.c_void_p, C.c_void_p, C.c_void_p,
                                      C.c_void_p]
    lib.enc_ctu_set_ref.argtypes = [
        C.c_void_p, C.c_int, C.c_int, C.c_void_p, C.c_void_p, C.c_void_p,
        C.c_void_p, C.c_int, C.c_int, C.c_int, C.c_int, C.c_int]
    lib.enc_ctu_set_col.argtypes = [
        C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p,
        C.c_void_p, C.c_int, C.c_int, C.c_int]
    lib.enc_ctu_qg_start.argtypes = [
        C.c_void_p, C.c_int, C.c_double, C.c_double, C.c_double]
    lib.enc_ctu_set_wp.argtypes = [C.c_void_p] + [C.c_int] * 10
    lib.enc_ctu_set_scaling.argtypes = [C.c_void_p, C.c_int, C.c_int,
                                        C.c_void_p]
    lib.enc_ctu_est_bits.restype = C.c_double
    lib.enc_ctu_est_bits.argtypes = [C.c_void_p, C.c_longlong]
    _LIB = lib
    return lib


def try_load():
    """Load the native library, or None when the toolchain is absent."""
    try:
        return _load()
    except Exception:
        return None


I8 = np.int8
I32 = np.int32
U8 = np.uint8


def _get(lib, fn, h, idx, shape, dtype):
    a = np.empty(shape, dtype)
    getattr(lib, fn)(C.c_void_p(h), C.c_int(idx),
                     a.ctypes.data_as(C.c_void_p))
    return a


class NativeParsedPicture:
    """PicSyntax-compatible view over the native parser output."""

class _NativeHandle:
    """Owns a native decoder handle; freed when the last referent dies.

    Zero-copy output views (below) keep a reference, so decoded-plane
    memory stays valid for as long as any returned array is alive."""

    def __init__(self, lib, h):
        self.lib, self.h = lib, h

    def __del__(self):
        try:
            self.lib.hevcdec_destroy(C.c_void_p(self.h))
        except Exception:
            pass


class _PlaneView:
    """__array_interface__ adapter over a native plane pointer; holds the
    _NativeHandle so np.asarray(view).base keeps the memory alive."""

    def __init__(self, ptr, shape, strides, holder):
        self.__array_interface__ = dict(
            shape=shape, typestr="<u2", data=(ptr, False),
            strides=strides, version=3)
        self._holder = holder


def _materialize(lib, h, i, recon, view_holder=None):
    """Materialize decoded picture i from the native handle as (meta, pic)."""
    info = np.zeros(16, I32)
    lib.hevcdec_pic_info(C.c_void_p(h), C.c_int(i),
                         info.ctypes.data_as(C.c_void_p))
    (poc, nal_type, tid, output_flag, sps_id, pps_id, w4, h4, nctu,
     ntu, ncoef, nintra, ninter, npcm, npcm_samp, _) = [int(v) for v in info]
    sinfo = np.zeros(32, I32)
    lib.hevcdec_sps_info(C.c_void_p(h), C.c_int(i),
                         sinfo.ctypes.data_as(C.c_void_p))
    pic = PicSyntax.__new__(PicSyntax)
    pic.w4, pic.h4 = w4, h4
    if recon:
        # full decode happens in C++; skip materialising the parse
        # products (maps / TU / PU lists) on the Python side
        pic.tu_list, pic.intra_list = [], []
        pic.inter_list, pic.pcm_list = [], []
        pic.slice_headers = []
        meta = dict(poc=poc, nal_type=nal_type, temporal_id=tid,
                    output_flag=output_flag, sps=sinfo)
        outs = []
        for comp in range(3 if int(sinfo[2]) else 1):
            oi = np.zeros(3, I32)
            lib.hevcdec_output_info(C.c_void_p(h), C.c_int(i),
                                    C.c_int(comp),
                                    oi.ctypes.data_as(C.c_void_p))
            ow, oh, bps = int(oi[0]), int(oi[1]), int(oi[2])
            if bps == 2 and view_holder is not None:
                # zero-copy: strided uint16 view straight into the native
                # plane (Pel is uint16); the view
                # pins the handle via _PlaneView._holder
                vi = np.zeros(2, np.int64)
                lib.hevcdec_output_view(C.c_void_p(h), C.c_int(i),
                                        C.c_int(comp),
                                        vi.ctypes.data_as(C.c_void_p))
                outs.append(np.asarray(_PlaneView(
                    int(vi[0]), (oh, ow), (int(vi[1]) * 2, 2), view_holder)))
                continue
            a = np.empty((oh, ow), np.uint8 if bps == 1 else np.uint16)
            lib.hevcdec_get_output(C.c_void_p(h), C.c_int(i),
                                   C.c_int(comp),
                                   a.ctypes.data_as(C.c_void_p))
            outs.append(a)
        meta["cropped"] = outs
        return meta, pic
    g = lambda fn, shape, dt: _get(lib, fn, h, i, shape, dt)
    pic.depth = g("hevcdec_get_depth", (h4, w4), I8)
    pic.pred_mode = g("hevcdec_get_pred_mode", (h4, w4), I8)
    pic.part_size = g("hevcdec_get_part_size", (h4, w4), I8)
    pic.skip = g("hevcdec_get_skip", (h4, w4), I8)
    pic.pcm = g("hevcdec_get_pcm", (h4, w4), I8)
    pic.tq_bypass = g("hevcdec_get_tq_bypass", (h4, w4), I8)
    pic.intra_y = g("hevcdec_get_intra_y", (h4, w4), I8)
    pic.intra_c = g("hevcdec_get_intra_c", (h4, w4), I8)
    pic.chroma_dm = g("hevcdec_get_chroma_dm", (h4, w4), I8)
    pic.qp = g("hevcdec_get_qp", (h4, w4), I8)
    pic.cbf_y = g("hevcdec_get_cbf_y", (h4, w4), I8)
    pic.inter_dir = g("hevcdec_get_inter_dir", (h4, w4), I8)
    pic.ref_idx = g("hevcdec_get_ref_idx", (h4, w4, 2), I8)
    pic.ref_is_lt = g("hevcdec_get_ref_is_lt", (h4, w4, 2), I8)
    pic.mv = g("hevcdec_get_mv", (h4, w4, 2, 2), I32)
    pic.ref_poc = g("hevcdec_get_ref_poc", (h4, w4, 2), I32)
    pic.slice_idx = g("hevcdec_get_slice_idx", (h4, w4), I32)
    pic.edge_flags = g("hevcdec_get_edge_flags", (h4, w4), U8)
    pic.deblock_disable = g("hevcdec_get_deblock_disable", (h4, w4), I8)
    pic.beta_offset = g("hevcdec_get_beta_offset", (h4, w4), I8)
    pic.tc_offset = g("hevcdec_get_tc_offset", (h4, w4), I8)
    pic.loopfilter_across_slice = g("hevcdec_get_lf_across", (h4, w4), I8)
    pic.sao_type = g("hevcdec_get_sao_type", (nctu, 3), I8)
    pic.sao_band_pos = g("hevcdec_get_sao_band", (nctu, 3), I8)
    pic.sao_offsets = g("hevcdec_get_sao_offsets", (nctu, 3, 4), I32)

    tu_meta = g("hevcdec_get_tu_meta", (max(ntu, 1), 14), I32)
    coeffs = g("hevcdec_get_coeffs", (max(ncoef, 1),), I32)
    pic.tu_list = []
    for t in range(ntu):
        # trailing last_row/last_col are native-recon hints; slots exported
        # here are always fully zeroed
        (comp, x, y, w, hh, qp, use_dst, ts, byp, rdpcm, alpha,
         off) = [int(v) for v in tu_meta[t][:12]]
        blk = coeffs[off:off + w * hh].reshape(hh, w)
        pic.tu_list.append(TransformUnit(
            comp, x, y, w, hh, blk, qp, bool(use_dst), ts, byp,
            rdpcm, alpha))
    im = g("hevcdec_get_intra_meta", (max(nintra, 1), 7), I32)
    pic.intra_list = [IntraBlock(int(r[0]), int(r[1]), int(r[2]),
                                 int(r[3]), int(r[4]), int(r[5]), 0,
                                 int(r[6])) for r in im[:nintra]]
    pu_sz = 30  # sizeof(PuMeta)/4 (x,y,w,h,dir,merge,merge_idx,mv,ref,...)
    pm = g("hevcdec_get_inter_meta", (max(ninter, 1), pu_sz), I32)
    pic.inter_list = []
    for r in pm[:ninter]:
        pu = InterPU(int(r[0]), int(r[1]), int(r[2]), int(r[3]),
                     int(r[4]),
                     [(int(r[7]), int(r[8])), (int(r[9]), int(r[10]))],
                     [int(r[11]), int(r[12])],
                     [int(r[13]), int(r[14])])
        pu.merge = int(r[5])
        pu.merge_idx = int(r[6])
        if int(r[15]):  # has_wp
            # layout: denom_l, denom_c, w[2][3], o[2][3]
            ww = [[int(r[18 + l * 3 + c]) for c in range(3)] for l in range(2)]
            oo = [[int(r[24 + l * 3 + c]) for c in range(3)] for l in range(2)]
            pu.wp = {"denom_l": int(r[16]), "denom_c": int(r[17]),
                     "w": ww, "o": oo}
        pic.inter_list.append(pu)
    pcm_meta = g("hevcdec_get_pcm_meta", (max(npcm, 1), 7), I32)
    pcm_samples = g("hevcdec_get_pcm_samples", (max(npcm_samp, 1),), I32)
    pic.pcm_list = []
    for r in pcm_meta[:npcm]:
        comp, x, y, w, hh, bits, off = [int(v) for v in r]
        pic.pcm_list.append((comp, x, y, w, hh,
                             pcm_samples[off:off + w * hh].reshape(hh, w),
                             bits))
    pic.slice_headers = []
    meta = dict(poc=poc, nal_type=nal_type, temporal_id=tid,
                output_flag=output_flag, sps=sinfo)
    return meta, pic

class NativeStream:
    """Incremental NAL-push native parser (libHMDec protocol backend).

    feed() one EBSP NAL at a time (2-byte header, no start code); completed
    pictures come back as (meta, PicSyntax) as soon as the parser sees the
    next picture's first slice.  flush() finalizes the open picture.
    """

    def __init__(self, recon: bool = False):
        self.lib = _load()
        self.h = self.lib.hevcdec_create()
        self.recon = recon
        if recon:
            self.lib.hevcdec_enable_recon(C.c_void_p(self.h), 1)
        self._count = 0

    def feed(self, ebsp: bytes):
        n = self.lib.hevcdec_feed(C.c_void_p(self.h), ebsp, len(ebsp))
        return self._drain(n)

    def flush(self):
        n = self.lib.hevcdec_flush(C.c_void_p(self.h))
        return self._drain(n)

    def _drain(self, n):
        out = [_materialize(self.lib, self.h, i, self.recon)
               for i in range(self._count, n)]
        self._count = n
        return out

    def close(self):
        if self.h is not None:
            self.lib.hevcdec_destroy(C.c_void_p(self.h))
            self.h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def parse_stream(data: bytes, recon: bool = False):
    """Parse an Annex-B stream natively; returns list of (info, PicSyntax).

    With recon=True the native library also reconstructs every picture
    (residuals + intra + MC + deblock + SAO in C++); the cropped output
    planes are attached as meta["cropped"].
    """
    lib = _load()
    h = lib.hevcdec_create()
    holder = _NativeHandle(lib, h)   # destroys h when the last view dies
    if recon:
        lib.hevcdec_enable_recon(C.c_void_p(h), 1)
    with obs.span("parse.native") as s:
        npic = s.n = lib.hevcdec_decode(h, data, len(data))
    with obs.span("parse.export", npic):
        return [_materialize(lib, h, i, recon, view_holder=holder)
                for i in range(npic)]
