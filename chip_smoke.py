#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (libhm_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure (the exit code is then non-zero and the
result line is not printed).  Bounds are the larger of the bytes at the
card's HBM rate and the integer operations at its int32 rate (64 INT32
lanes an SM x 2 for a multiply-add x SMs x the maximum SM clock,
libhm_tpu_torch/utils/timing.py int32_ops_per_s).

 1. card name and power limit (nvidia-smi); CUDA must be available;
 2. build the port's native host parser (libhm_tpu_torch/hostdec/native),
    its libHMDec C ABI (libhmdec.so) and every kernel of csrc/ (one nvcc
    per source), all at once, timed;
 3. K1-K9 and K1's CCP epilogue (row 11, which was K10) against their
    plain torch versions on the card, at the shapes
    of the 1080p main paths, on seeded inputs: exact equality, with both
    times, the bound (bytes or operations at the card's peak rates) and,
    for K7 and K8, the time of the library call that computes the same
    function.  K1 runs one launch per (DAG level, component) over the
    flat TU tables of the RA stream's levels (real TU positions, sizes and
    modes, seeded coefficients), beside the per-bucket wrapper on the same
    TUs; its scaled mode on the tool stream's tables, its bypass mode on
    the same rows made bypass (rotation at 4x4, seeded RDPCM).  K2 (one
    launch per component) over the whole luma and both chroma wavefronts
    of the first 1080p intra picture (row 14; luma alone is K2's line),
    five kernel runs each against one plain run, luma also with a grid of
    one CTA, beside its chain-depth bound: the levels times one dependent
    L2 round trip, measured by a one-thread pointer chase (csrc/probe.cu);
    K6 on a seeded 1080p level of random per-4x4 MVs and on one of 8x8 to
    64x64 PUs (tests/mc_cases.py), 20 launches bit-identical with the
    luma rows grouped by tile beforehand and 20 on the rows as they come,
    with its device time queued behind a sleep; K7 over 51 cropped 1080p views, its
    device time and no upload;
    K4's multi form with the tool stream's slice/tile maps, K8 on a seeded
    mask at 1920x1088, K9 in one launch on a seeded 1080p 4:2:0 level (luma
    and both chroma planes, a PCM CU in about a third of the 32x32 cells;
    tests/pcm_cases.py) and on a 4:2:2 one, with its device time beside
    the byte bound, K3 chroma's int16-tc form on a 12-bit 960x544 plane,
    K1's CCP epilogue on a seeded 1080p 4:4:4 chroma level (two pictures,
    every 32x32 cell tiled with TUs of every mode, an alpha on 30% of them;
    tests/ccp_cases.py), 20 launches bit-identical, against
    residual_table_plain and against the table without alphas followed by
    ccp_apply_plain, timed with and without its alphas, and at luma 8 /
    chroma 12 and luma 12 / chroma 8 bits (the luma residual scaled by
    H.265 8.6.6), timed beside the same table at equal depths; then K3
    chroma, K4
    and K5 chroma again at the RExt chroma
    geometries, 4:2:2 (960x1088, 32x64 chroma CTBs, 2x4 MC blocks) and
    4:4:4 (1920x1088), their errors joining those kernels' results (K3
    and K4 through their single-pass entry points); the loop-filter level
    kernel (K3 + K4 in one launch per level, csrc/loopfilter.cu) on the
    RA stream's largest level (the decode's own maps, seeded planes; 20
    launches bit-identical), on one RA picture beside the nine
    single-pass launches that filter it pass by pass (enqueue rate and
    device time), on the tool stream's multi-slice/tile maps and on
    seeded 12-bit, 4:2:2, 4:4:4, SAO-off and one-CTA levels
    (tests/lf_cases.py); row 15 of the kernel table: K5 and the level
    kernel on one picture; and at 16 bits (the hbd phase's kernels,
    check_hbd; errors join the kernels' lines): K1 on the same RA and tool
    tables (flat with DST and 4x4 transform skip, scaled), K2 on the intra
    picture's luma wavefront and the loop-filter level kernel on a seeded
    1080p 4:2:0 level, each timed beside the same shapes at 10 bits; the
    level kernel on the 16-bit stream's own level (int16 chroma tc, band
    shift 11, SAO offset scale 6); K3 chroma's int16-tc form, K4, K5 and
    K6 (weighted and plain epilogues, and weighted with the offsets of
    high_precision_offsets_enabled_flag, +-2^15; K5 and K6 also at 14
    bits), K7, K8,
    and K9 with 16-bit PCM samples of 2^15 and more; and K1's wide form
    (extended precision, check_ext): seeded 1080p 4:4:4 tables at 10, 12,
    14 and 16 bits (tests/ext_cases.py: every mode, levels over
    [-2^(bd+6), 2^(bd+6) - 1], a luma table of F_EXT rows and a chroma
    table with CCP rows and a quarter of its rows without F_EXT), and the
    real level of the extended-precision 1080p stream, each component
    timed beside the same level of the stream without the flag (K1's
    int16 form);
 4. the main paths, each with the launch counters reset just before it and
    read just after, and the reference-DAG levels it reconstructs counted:
    K1 and K2 launch at most once per component and level on every path,
    the loop-filter kernel exactly once per level and no single-pass
    K3/K4 entry point;
    - testdata/randomaccess_main10_1080p.bin pushed NAL by NAL through
      libhm_tpu_torch.api.HmDecoder (native parse, recon="torch" on the
      card: each picture reconstructed as soon as it is parsed) and every
      picture pulled: golden MD5, K1-K5 launched, no reference plane
      uploaded, peak device memory under (DPB size + 3) pictures + 256
      MiB; time to the first picture, fps, recon ms per picture;
    - the small streams of PICTURE_SMALL through HmDecoder with the hash
      SEI check: their MD5s (field_ra_160x96: every hash SEI OK), each
      with the kernel modes it is there for;
    - the golden sweep: the seven small goldens of SWEEP through
      HmDecoder, their MD5s; lowdelayP_main10_4k through decode_batch: its
      MD5, fps, K2 launches and peak device memory under what the path
      holds by design; and through HmDecoder: its MD5, fps, time to the
      first picture and peak device memory under (DPB size + 3) pictures
      + 256 MiB;
    - the dec_app CLI on lowdelayP_416x240 (a subprocess): exit 0 and the
      YUV's golden MD5;
    - decode_intra_batch on the all-intra 1080p stream: golden MD5, every
      hash SEI OK, K1-K4;
    - entry()'s fused recon step at 1080p (K1, K6, the loop-filter
      kernel with V + SAO, K7) equal to its plain version, sum and frame,
      timed (row 16), with K6's and K7's device time in one step
      (torch.profiler);
    - testdata/randomaccess_main10_1080p.bin through
      parallel.dag_decode.decode_batch(device="cuda"): golden MD5, K1-K5
      launched; the inputs K1 and K5 get on its level with the most
      pictures are kept, and both kernels are then held against their
      plain versions on them and timed (the decode's own coefficients,
      TU tables, MV maps and reference planes);
    - testdata/wp_lowdelayP_416x240.bin the same way: golden MD5, K6's
      launches and its device time summed over a second decode
      (torch.profiler, device events only);
    - decode_batch_device on the 1080p RA stream: its checksum equals
      cropped_checksum of the decoded pictures, K7 launched once, nothing
      uploaded for it, 4 bytes down; the H2D memcpy count of a second run;
    - the all-intra 1080p and 416x240 streams: golden MD5, K1-K4;
    - testdata/tools_main10_1080p.bin (6 slices, 2 tiles, scaling lists;
      testdata/port_streams.json) through decode_batch(device="cuda",
      check_sei_hash=True): its MD5, K1 scaled and the loop filter's
      multi-slice/tile SAO form launched, and
      decode_batch_device on it: the checksum of those pictures;
    - the slice, tile, PCM, lossless and scaling-list goldens and the PCM
      stream of port_streams.json: their MD5s, each with the launches of
      the modes it needs (K1 scaled / bypass, SAO multi, K8, K9), and on
      pcm_port_416x240 (here and through HmDecoder) exactly one K9 launch
      and one `pcm` upload for its one PCM level;
    - testdata/rext422_main10_1080p.bin (Main 4:2:2 10, I then P;
      port_streams.json) through decode_batch(check_sei_hash=True): its
      MD5, K1-K5 launched, and decode_batch_device: the checksum of those
      pictures;
    - the 13 RExt goldens (4:2:2, 4:4:4 with cross-component prediction,
      4:0:0, 12 bits): their MD5s, with K1's CCP epilogue on the CCP
      streams (on rext444_randomaccess_416x240 one K1 launch with CCP rows
      per chroma component of each level that has a CCP TU) and the loop
      filter's int16-tc form on the 12-bit one;
    - decode_streams over two 4:2:0 streams of one geometry, one of them
      twice: each stream's MD5;
    - the hbd phase (bit depths 13-16): testdata/rext444_16b_intra_1080p
      (Main 4:4:4 16 Intra, the repo's encoder; port_streams.json) and its
      proxies rext444_16b_intra_160x96 and main14_intra_160x96 through
      decode_intra_batch, decode_batch and HmDecoder (MD5 and every hash
      SEI OK) and decode_batch_device (checksum equal to cropped_checksum),
      with the 1080p stream's fps through each; then the inter streams at
      13-16 bits, testdata/mono16_ra_1080p (Monochrome 16 random access,
      the port's encoder), its proxy mono16_ra_160x96 and the 14-bit 4:2:0
      main14_ra_160x96 (explicit weighted prediction in its first coded
      video sequence), through decode_batch, HmDecoder and
      decode_batch_device the same way, mc_grid launched on every path and
      mc_weighted on main14_ra_160x96's, with each path's fps;
    - the extprec phase: testdata/rext444_16b_intra_1080p_extprec (that
      stream with extended_precision_processing_flag set;
      tools/make_extprec_stream.py, port_streams.json) through
      decode_intra_batch, decode_batch and HmDecoder (its MD5; the hash
      SEIs hash the decode without the flag and are not checked) and
      decode_batch_device (checksum equal to cropped_checksum), K1's wide
      form launched on each path, fps of each;
    - the multi-device decode (multidevice_phase): the RA 1080p stream
      through decode_batch and decode_batch_device with
      devices=["cuda:0", "cuda:0"] (each level's pictures split into
      contiguous shards of ceil(B / 2)): golden MD5, K1, K2, K5 and
      loop-filter launches equal to predicted_launches, the checksum from
      one K7 launch per entry; intra_main10_1080p through
      decode_intra_batch on the same list; decode_streams of four 416x240
      streams over cuda:{i % count}; tids4_ra_160x96 and
      randomaccess_416x240 over ["cuda:0", "cpu"], with the references
      crossing devices as counted peer copies; on a host with several
      cards the same over one entry per card and dryrun_multidevice;
      decode_batch fps with one entry and with each list, in turn;
    - the encoder (encoder_phase), its in-loop filter on the card:
      testdata/rext444_16b_intra_160x96 re-encoded through enc_app
      --device cuda from its cfg's recipe (tests/enc_cases.py) to the
      committed bytes; a picture coded partly as PCM with
      pcm_loop_filter_disabled (K8 on the encoder's path) to the bytes of
      the same encode on the CPU; the first two pictures of the RA 1080p
      stream (Main10) encoded lowdelayP with SAO, the stream decoded by
      decode_batch on the card with every hash SEI OK and to the
      encoder's reconstructions, each picture's filter equal to the
      port's numpy one (hostdec/loopfilter_np, which the encode itself
      may not call) and both timed; encode fps, the host split (the CTU
      pass, _estimate_sao, the filter, _emit_slices) and the filter's
      launches, device time and H2D / D2H bytes; every loop-filter
      launch (2 a picture: deblocking, then SAO) and K8 launch held
      against its plain version on CPU copies of its inputs; the picture
      of ROADMAP C3 (tests/enc_cases.py C3_CASES, a rejected PCM trial
      whose marks the encoder rolls back) encoded on the card to the
      bytes of the CPU encode and decoded by decode_batch on the card
      with its hash SEI OK, with K8's launches, the share of the picture
      under PCM marks and the samples K8 restored;
    - the C13 picture (pcm_flush_phase): pcm_frames(128, 64) at QP 8 with
      PCM, encoded on the card to the CPU encode's bytes, one of its
      flushes after pcm_flag ending on a byte boundary, decoded by
      decode_batch on the card with its hash SEI OK (K9 launched);
    - the host phase (host_phase): the port's annexb_bytecount,
      hostdec/stats.py collect_bits, convert_bitdepth and
      bitrate_targeting on the card's host, and the libHMDec C ABI
      (libhmdec.so, built alongside the kernels) pushing a golden and the
      16-bit and 14-bit streams mono16_ra_160x96,
      rext444_16b_intra_160x96 and main14_ra_160x96 to their MD5s with its
      MD5 SEI check passing;
 5. timed runs of the RA stream, of the tool stream and of the 4:2:2
    stream (every picture's hash SEI checked OK for the last two), and a
    breakdown (cProfile, torch.profiler) of the RA stream, with the intra
    tables' H2D bytes beside those of the per-(level, size) slot layout,
    the device time summed over device-side events only (kernels,
    memcpys, memsets; a CPU op's row carries the device time of what it
    launched), and K1's, K5's and the loop filter's launches and device
    time and the H2D memcpy count;
    then the bench phase (bench_phase): bench_torch.py's device section
    as a child process with one timed run and two streams (its checksum
    equal to the native CPU decode's, every MD5 golden, every line
    present) and tools/bench_kernels_torch.py's K1 and K6 rows at the
    JAX harness's shapes (exact, at most 100% of their bound);
 6. one JSON line of per-kernel results (the encoder's loop-filter and
    K8 launches in rows of their own), then the result line
    {"ok": true, "device": {...}}.
"""
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = "cuda"
STREAM = "randomaccess_main10_1080p"      # the main path: timed, broken down
INTRA = "intra_main10_1080p"              # the all-intra path of PR 1
SMALL = ("intra_main10_416x240", "intra_416x240")
WP = "wp_lowdelayP_416x240"               # the only weighted-prediction golden
TOOLS = "tools_main10_1080p"    # slices, tiles, scaling lists (port_streams)
# small streams of the tools path, and the kernel modes each must launch
TOOL_SMALL = {"slices_416x240": ["loop_filter_multi"],
              "tiles_832x480": ["loop_filter_multi"],
              "tiles_nolfcross_512x128": ["loop_filter_multi"],
              "pcm_intra_416x240": ["restore_unfiltered"],
              "pcm_reduceddepth_160x96": [],
              "pcm_port_416x240": ["pcm_level"],
              "lossless_intra_416x240": ["residual_bypass",
                                         "restore_unfiltered"],
              "scaling_intra_416x240": ["residual_scatter_scaled"],
              "customsl_lowdelay_160x96": ["residual_scatter_scaled"],
              "wppdep_lowdelay_160x96": ["residual_scatter"]}
REXT = "rext422_main10_1080p"   # Main 4:2:2 10, I then P (port_streams)
# the RExt goldens, and the kernel entry points each must launch beyond K2
REXT_SMALL = {"rext422_intra_416x240": ["loop_filter_level"],
              "rext422_lowdelayP_416x240": ["mc_grid"],
              "rext422_noRdoq_160x96": ["mc_grid"],
              "wpp422_ra_160x96": ["mc_grid"],
              "intra_rext444_416x240": ["residual_table_ccp"],
              "rext444_randomaccess_416x240": ["residual_table_ccp",
                                               "mc_grid"],
              "ccp444_lowdelay_160x96": ["residual_table_ccp", "mc_grid"],
              "ht_rext444_intra_160x96": ["residual_table_ccp"],
              "mono_intra_416x240": ["loop_filter_level"],
              "mono_lowdelay_160x96": ["mc_grid"],
              "main12_intra_416x240": ["loop_filter_ctc16"],
              "intra_rext444_nofilt": [],
              "intra_rext444_nosao": []}
# independent streams of one geometry through decode_streams
MULTI = ("randomaccess_416x240", "randomaccess_416x240", "lowdelayB_416x240")
# streams pushed through libhm_tpu_torch.api.HmDecoder (the per-picture
# path), and the kernel entry points each must launch beyond K2; the
# first five hold the control plane (bumping, temporal layers, field
# pictures, RASL skipping); FIELD is checked by its hash SEIs (golden.json)
FIELD = "field_ra_160x96"
PICTURE_SMALL = {"intra_64x64": [], "lowdelayP_416x240": ["mc_grid"],
                 "tids4_ra_160x96": ["mc_grid"], FIELD: [],
                 "cra_start_416x240": [],
                 "wp_lowdelayP_416x240": ["mc_weighted"],
                 "tiles_nolfcross_512x128": ["loop_filter_multi"],
                 "lossless_intra_416x240": ["residual_bypass",
                                            "restore_unfiltered"],
                 "pcm_port_416x240": ["pcm_level"],
                 "scaling_intra_416x240": ["residual_scatter_scaled"],
                 "ccp444_lowdelay_160x96": ["residual_table_ccp"],
                 "mono_lowdelay_160x96": ["mc_grid"],
                 "main12_intra_416x240": ["loop_filter_ctc16"],
                 "rext422_lowdelayP_416x240": ["mc_grid"]}
DEC_APP = "lowdelayP_416x240"             # through the dec_app CLI
# the golden sweep: goldens no other phase decodes, through HmDecoder, and
# the 4K golden through decode_batch
SWEEP = ("intra_qp22_416x240", "intra_nofilt_416x240", "intra_nosao_416x240",
         "dqp_intra_416x240", "chromaqp_ra_160x96",
         "cra_randomaccess_416x240", "randomaccess_416x240")
UHD = "lowdelayP_main10_4k"
# rows 14-16 of the kernel table (the JAX per-picture device programs and
# the fused entry step): key, the kernels that carry it, source, replaces
ROWS = (("row14", "_scan_fn per picture: intra_wavefront (K2), luma and "
         "both chroma wavefronts of one 1080p picture",
         "libhm_tpu_torch/csrc/intra.cu",
         "libhm_tpu/parallel/intra_wavefront.py:175"),
        ("row15", "_mc_fn, _deblock_v_fn, _deblock_cv_fn, _sao_fn per "
         "picture: mc_grid (K5), loop_filter_level (K3 + K4, one launch)",
         "libhm_tpu_torch/recon_torch.py",
         "libhm_tpu/recon_tpu.py:85"),
        ("row16", "_fused_recon_step: residual_scatter (K1), mc_weighted "
         "(K6), loop_filter_level (K3 V + K4, one launch), plane_checksum "
         "(K7)",
         "libhm_tpu_torch/entry.py", "__graft_entry__.py:22"))
# the encoder's rows of the kernel table (encoder_phase): key, the kernel
# and the work it was timed on, source, replaces
ENC_ROWS = (("enc_lf", "encoder in-loop filter: loop_filter_level (K3 + "
             "K4), the deblocking and the SAO launch of one 1080p Main10 "
             "picture", "libhm_tpu_torch/csrc/loopfilter.cu",
             "libhm_tpu/parallel/device_filters.py:102"),
            ("enc_k8", "encoder PCM restore: restore_unfiltered (K8), the "
             "three components of a 128x64 picture",
             "libhm_tpu_torch/csrc/pcm.cu",
             "libhm_tpu/parallel/device_filters.py:191"))
# the main path whose launches the kernel table reports, for the modes
# that the tool stream does not run
LAUNCHES_FROM = {"residual_bypass": "lossless_intra_416x240",
                 "restore_unfiltered": "lossless_intra_416x240",
                 "pcm_level": "pcm_port_416x240",
                 "residual_table_ccp": "rext444_randomaccess_416x240"}
# streams whose PCM levels and K1 launches with CCP rows are counted
# exactly: each level with a PCM block one K9 launch and one `pcm` upload,
# each chroma component of a level with a CCP TU one K1 launch with CCP
# rows
EXACT = ("pcm_port_416x240", "rext444_randomaccess_416x240")

# published H100 SXM peak HBM bytes/s (NVIDIA data sheet); the int32 rate
# that integer operations are held to is the card's own, set in main()
# (libhm_tpu_torch/utils/timing.py int32_ops_per_s); so are the timing
# helpers cuda_ms and device_ms of that module (the package is importable
# only once main() has checked the checkout)
HBM_BPS = 3.35e12
CORE_OPS = cuda_ms = device_ms = None


def log(msg):
    print(msg, flush=True)


def device_events(fn):
    """(fn()'s result, {event name: (device us, count)}) over one run of fn()
    under torch.profiler, device-side events only (kernels, memcpys,
    memsets): a CPU op's row carries the device time of what it launched,
    so summing every row would count that work twice."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        out = fn()
        torch.cuda.synchronize()
    dev = {}
    for e in p.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            dev[e.key] = (us, e.count)
    return out, dev


def dev_sum(dev, part):
    """(device ms, events) of the events whose name holds `part`."""
    hits = [v for k, v in dev.items() if part in k]
    return sum(us for us, _ in hits) / 1e3, sum(n for _, n in hits)


def max_abs_err(a, b):
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


class Result:
    """What phase 3 measured for one kernel entry point, summed over its
    checks: max error, kernel / plain / library ms, bytes and operations."""

    def __init__(self):
        self.err = 0
        self.ms = self.plain_ms = 0.0
        self.library_ms = None
        self.bytes = self.ops = 0

    def add(self, err, ms, plain_ms, nbytes, ops):
        self.err = max(self.err, err)
        self.ms += ms
        self.plain_ms += plain_ms
        self.bytes += int(nbytes)
        self.ops += int(ops)

    def bound(self):
        """(ms, 'bytes' or 'operations'): the least time for this work."""
        tb = self.bytes / HBM_BPS * 1e3
        to = self.ops / CORE_OPS * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")


def _k1_work(rows, coef_bytes=2):
    """(bytes, operations) of K1 over TU_DTYPE rows: each row, its
    coefficients (int16, or int32 in the wide form: coef_bytes), its int32
    residual samples and each scaling matrix it
    names once; the butterflies' multiply-adds (each 1-D pass 1.5 n per
    4 samples) and the dequant, or the shifts and RDPCM sums of transform
    skip and bypass rows."""
    import numpy as np
    from libhm_tpu_torch.ops import transform as TK
    n = np.left_shift(1, rows["log2n"].astype(np.int64))
    skip = (rows["flags"] & (TK.F_TSKIP | TK.F_BYPASS)) != 0
    ops = np.where(skip, 6 * n * n, 2 * 2 * n * n * (3 * n // 8) + 5 * n * n)
    ops = ops + np.where(rows["rdpcm"] != 0, n * n * (n + 1) // 2, 0)
    sc = rows[(rows["flags"] & TK.F_SCALED) != 0]
    mats = np.unique(sc["log2n"].astype(np.int64) << 8 | sc["midx"])
    nbytes = len(rows) * 16 + (n * n).sum() * (coef_bytes + 4) + \
        sum(1 << (2 * int(m >> 8)) for m in mats)
    return int(nbytes), int(ops.sum())


def _bucket_args(table_np, coeffs, mats):
    """The rows of one table split into per-bucket residual_scatter calls
    (one per size, mode and bit depth), on the card."""
    import numpy as np
    import torch
    from libhm_tpu_torch.ops import transform as TK
    rows = table_np
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)  # noqa
    key = rows["log2n"].astype(np.int64) | rows["flags"].astype(np.int64) \
        << 3 | rows["bd"].astype(np.int64) << 8
    calls = []
    for k in np.unique(key):
        i = np.nonzero(key == k)[0]
        r = rows[i]
        n = 1 << int(r["log2n"][0])
        fl = int(r["flags"][0])
        c = np.stack([coeffs[o:o + n * n] for o in r["off"]]).reshape(-1, n, n)
        scaled = bool(fl & TK.F_SCALED)
        kw = dict(n=n, use_dst=bool(fl & TK.F_DST), tskip=bool(fl & TK.F_TSKIP),
                  bd=int(r["bd"][0]), bypass=bool(fl & TK.F_BYPASS),
                  rotate=bool(fl & TK.F_ROTATE),
                  mats=mats[n] if scaled else None,
                  midx=t(r["midx"]) if scaled else None,
                  rdpcm=t(r["rdpcm"].astype(np.int8)) if r["rdpcm"].any()
                  else None)
        calls.append(((t(c), t(r["qp"]), t(r["b"].astype(np.int32)),
                       t(r["y"].astype(np.int32)), t(r["x"].astype(np.int32))),
                      kw))
    return calls


def check_k1(levels, card, rng, label="residual_scatter", bypass=False,
             bd=None):
    """K1 on the TUs of every level of a stream: one table launch per
    (level, component) at the real TU positions, sizes and modes, with
    seeded coefficients and qp, against its plain version, and beside it
    the per-bucket wrapper (residual_scatter, one launch per size, mode
    and bit depth) on the same TUs.  bypass: every row as a transquant
    bypass TU instead (rotated at 4x4, a seeded RDPCM direction each).
    bd: every row at this bit depth instead of the stream's (its qp range
    with it)."""
    import numpy as np
    import torch
    from libhm_tpu_torch.ops import transform as TK
    from libhm_tpu_torch.parallel import batch_decode as TB
    r = Result()
    wrap_ms, dev_ms, launches, buckets = 0.0, 0.0, 0, 0
    for items in levels:
        sps = items[0]["sps"]
        Hp = sps.pic_height_ctbs << sps.log2_ctb
        Wp = sps.pic_width_ctbs << sps.log2_ctb
        tables, lists = TB.residual_tables(items)
        mats = TB._MatrixTable(lists, DEV).tables
        for c, (rows, coeffs, counts, flags) in enumerate(tables):
            if not len(rows):
                continue
            rows = rows.copy()
            if bd is not None:
                rows["bd"] = bd
            if bypass:
                rows["flags"] = TK.F_BYPASS | np.where(
                    rows["log2n"] == 2, TK.F_ROTATE, 0)
                rows["rdpcm"] = rng.integers(0, 3, len(rows))
                coeffs = rng.integers(-512, 512, coeffs.size).astype(np.int16)
                flags = TK.F_BYPASS | TK.F_ROTATE
            else:
                rows["qp"] = rng.integers(0, 52 + 6 * (rows["bd"] - 8))
                coeffs = rng.integers(-2048, 2048, coeffs.size) \
                    .astype(np.int16)
            table = TB.upload_tables([(rows, coeffs, counts, flags)], DEV)[0]
            sh = (1 if c and sps.chroma_shift_y() else 0,
                  1 if c and sps.chroma_shift_x() else 0)
            shape = (len(items), Hp >> sh[0], Wp >> sh[1])
            got = torch.zeros(shape, dtype=torch.int32, device=DEV)
            want = torch.zeros(shape, dtype=torch.int32, device=DEV)
            TK.residual_table(got, table, mats)
            TK.residual_table_plain(want, table, mats)
            calls = _bucket_args(rows, coeffs, mats)
            per_bucket = torch.zeros(shape, dtype=torch.int32, device=DEV)
            for a, kw in calls:
                TK.residual_scatter(per_bucket, *a, **kw)
            torch.cuda.synchronize()
            e = max(max_abs_err(got, want), max_abs_err(per_bucket, want))
            bms = cuda_ms(lambda: TK.residual_table(got, table, mats), 20)
            dev_ms += device_ms(lambda: TK.residual_table(got, table, mats),
                                20)
            pms = cuda_ms(lambda: TK.residual_table_plain(want, table, mats),
                          3)
            wms = cuda_ms(lambda: [TK.residual_scatter(per_bucket, *a, **kw)
                                   for a, kw in calls], 10)
            r.add(e, bms, pms, *_k1_work(rows))
            wrap_ms += wms
            launches += 1
            buckets += len(calls)
    log(f"K1 {label} ({'bypass rows' if bypass else 'seeded coefficients'}"
        f"{'' if bd is None else f' at {bd} bits'}, {len(levels)} levels): {launches} table launches (one per level "
        f"and component) {r.ms:.4f} ms (device, queued behind a sleep: "
        f"{dev_ms:.4f} ms), the per-bucket wrapper on the same TUs {buckets} "
        f"launches {wrap_ms:.4f} ms, plain {r.plain_ms:.4f} ms; max abs err "
        f"{r.err} ({card})")
    return r


def l2_round_trip_us(card):
    """Microseconds of one dependent L2 round trip: one thread chasing
    indices through a 4 MB buffer (past L1, inside L2), timed at two chain
    lengths so that the launch cancels out."""
    import numpy as np
    import torch
    from libhm_tpu_torch.kernels import build as KB
    chase = KB.Kernel("l2_chase", [KB.P, KB.I, KB.P])
    lines = (4 << 20) // 128                # one hop per 128-byte line
    order = np.random.default_rng(5).permutation(lines)
    nxt = np.zeros(lines * 32, np.int32)
    nxt[order * 32] = np.roll(order, -1) * 32       # one cycle, all lines
    nxt = torch.from_numpy(nxt).to(DEV)
    out = torch.zeros(1, dtype=torch.int32, device=DEV)
    short, long_ = 20000, 220000
    t_short = cuda_ms(lambda: chase(KB.ptr(nxt), short, KB.ptr(out)), 3)
    t_long = cuda_ms(lambda: chase(KB.ptr(nxt), long_, KB.ptr(out)), 3)
    us = (t_long - t_short) * 1e3 / (long_ - short)
    log(f"L2 round trip (one-CTA pointer chase, 4 MB, __ldcg): {us:.4f} us "
        f"({short} hops {t_short:.3f} ms, {long_} hops {t_long:.3f} ms; "
        f"{card})")
    return us


def check_k2(items, card, rng, rt_us, bd=None, comps=(0, 1, 2), res_bits=6,
             warm=True):
    """K2 over the whole wavefront of each component of picture 0 (row 14,
    the per-picture path; luma alone is K2's own line): one launch per
    component, five kernel runs each equal to one plain run, the kernel
    timed; luma also with a grid of one CTA; then one launch over every
    component (as the decode paths launch it), equal and timed.  bd: the
    components at this bit depth instead of the stream's; residuals are
    seeded in +-2^res_bits; warm=False leaves out the plain version's
    warm-up run (its ops are warm from an earlier call).  Returns (luma
    Result, row 14 Result over `comps`)."""
    import numpy as np
    import torch
    from libhm_tpu_torch.ops import intra as IK
    from libhm_tpu_torch.parallel.batch_decode import intra_meta
    it = items[0]
    sps = it["sps"]
    luma, row14 = Result(), Result()
    depth, kept = {}, {}
    for comp in comps:
        sx = sps.chroma_shift_x() if comp else 0
        sy = sps.chroma_shift_y() if comp else 0
        Hp = (sps.pic_height_ctbs << sps.log2_ctb) >> sy
        Wp = (sps.pic_width_ctbs << sps.log2_ctb) >> sx
        cbd = bd or (sps.bit_depth_chroma if comp else sps.bit_depth_luma)
        kw = dict(is_luma=comp == 0, bd=cbd, W=sps.width >> sx,
                  H=sps.height >> sy)
        table = intra_meta([it], comp, DEV)
        rows = IK.block_rows(table)
        per_level = np.bincount(rows["level"])
        depth[comp] = len(per_level)
        res = torch.from_numpy(rng.integers(
            -(1 << res_bits), (1 << res_bits) + 1, (1, Hp, Wp))
            .astype(np.int32)).to(DEV)
        zero = torch.zeros((1, Hp, Wp), dtype=torch.int32, device=DEV)
        # the plain version takes seconds a run on the card: its one run
        # is both the comparison and its time (its ops are warm by now)
        if warm:
            IK.intra_wavefront_plain(zero.clone(), res, table, **kw)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = IK.intra_wavefront_plain(zero.clone(), res, table, **kw)
        end.record()
        torch.cuda.synchronize()
        pms = start.elapsed_time(end)
        n0 = IK._K2.launches
        e, bad = 0, 0
        for _ in range(5):
            got = IK.intra_wavefront(zero.clone(), res, table, **kw)
            torch.cuda.synchronize()
            e = max(e, max_abs_err(got, want))
            bad += int((got != want).sum())
        launches = IK._K2.launches - n0
        scratch = zero.clone()
        bms = cuda_ms(lambda: IK.intra_wavefront(scratch, res, table, **kw),
                      5)
        sizes = {1 << int(l): int(c) for l, c in
                 zip(*np.unique(rows["nf"] & 15, return_counts=True))}
        # per block: 4n+1 border samples and n*n residuals in, n*n out
        # (int32), its 32-byte row, the level counts once; ~10 operations
        # per predicted sample
        nbytes = sum(c * ((4 * n + 1) * 4 + n * n * 8 + 32)
                     for n, c in sizes.items()) + depth[comp] * 4
        ops = sum(c * n * n * 10 for n, c in sizes.items())
        r1 = ""
        if comp == 0:
            got = IK.intra_wavefront(zero.clone(), res, table, _ctas=1, **kw)
            torch.cuda.synchronize()
            e = max(e, max_abs_err(got, want))
            bad += int((got != want).sum())
            one = cuda_ms(lambda: IK.intra_wavefront(scratch, res, table,
                                                     _ctas=1, **kw), 1)
            r1 = f", one CTA {one:.4f} ms"
            luma.add(e, bms, pms, nbytes, ops)
        row14.add(e, bms, pms, nbytes, ops)
        kept[comp] = (zero, res, want, kw)
        log(f"K2 intra_wavefront picture 0 comp {comp} bd={cbd}: "
            f"{len(rows)} blocks "
            f"{sizes}, {depth[comp]} levels (blocks per level median "
            f"{int(np.median(per_level))}, max {int(per_level.max())}), "
            f"{launches} launches for 5 runs: "
            f"mismatches={bad} over 5 runs{' and the one-CTA run' * (comp == 0)}"
            f"; kernel {bms:.4f} ms{r1}, plain {pms:.4f} ms; bound: bytes "
            f"{nbytes / HBM_BPS * 1e3:.6f} ms, chain {depth[comp]} x "
            f"{rt_us:.4f} us = {depth[comp] * rt_us / 1e3:.4f} ms ({card})")
    if len(comps) > 1:
        table = intra_meta([it], tuple(comps), DEV)
        kws = [kept[c][3] for c in comps]
        args = {k: [kw[k] for kw in kws] for k in kws[0]}
        got = IK.intra_wavefronts([kept[c][0].clone() for c in comps],
                                  [kept[c][1] for c in comps], table, **args)
        torch.cuda.synchronize()
        bad = sum(int((g != kept[c][2]).sum()) for g, c in zip(got, comps))
        planes = [kept[c][0].clone() for c in comps]
        fms = cuda_ms(lambda: IK.intra_wavefronts(
            planes, [kept[c][1] for c in comps], table, **args), 5)
        log(f"row 14 K2 over picture 0's {len(comps)} wavefronts in ONE "
            f"launch: mismatches={bad}; kernel {fms:.4f} ms against "
            f"{row14.ms:.4f} ms in {len(comps)} launches ({card})")
        if bad:
            raise AssertionError(f"K2 one launch over {comps}: {bad} samples "
                                 "differ from the plain version")
    chain = sum(depth.values()) * rt_us / 1e3
    sets = "chain" if chain > row14.bound()[0] else row14.bound()[1]
    log(f"row 14 (_scan_fn per picture) K2 over picture 0's "
        f"{len(comps)} wavefronts, one launch each: kernel {row14.ms:.4f} ms, plain "
        f"{row14.plain_ms:.4f} ms; bound: {row14.bound()[1]} "
        f"{row14.bound()[0]:.6f} ms, chain {sum(depth.values())} levels x "
        f"{rt_us:.4f} us = {chain:.4f} ms (the {sets} sets it) ({card})")
    return luma, row14


def _smooth_plane(rng, shape, bd):
    """Piecewise-flat picture with small noise, so that deblocking sees
    flat, weak and strong edges."""
    import numpy as np
    H, W = shape
    base = rng.integers(0, 1 << bd, (H // 4 + 1, W // 4 + 1))
    base = (base >> 3) + (1 << (bd - 1)) - (1 << (bd - 4))
    plane = np.repeat(np.repeat(base, 4, 0), 4, 1)[:H, :W]
    plane = plane + rng.integers(-2, 3, (H, W))
    return np.clip(plane, 0, (1 << bd) - 1).astype(np.int32)[None]


def check_k3(card, rng, bd=10, sx=1, sy=1, with_luma=True):
    """K3 luma on 1920x1088 and chroma on 1920x1088 shifted by (sx, sy)
    (960x544 in 4:2:0, 960x1088 in 4:2:2), V and H.  Above 11 bits only
    chroma, through its int16-tc entry point (tc reaches 24 << 4, past a
    byte); with_luma=False leaves luma out."""
    import numpy as np
    import torch
    from libhm_tpu_torch.ops import deblock as DK
    H, W = 1088, 1920
    h4, w4 = H // 4, W // 4
    wide = bd > 11
    bs = rng.integers(0, 3, (1, h4, w4)).astype(np.uint8)
    nop = (rng.random((1, h4, w4)) < 0.05).astype(np.uint8)
    noq = (rng.random((1, h4, w4)) < 0.05).astype(np.uint8)
    bsn_np = bs | (nop << 4) | (noq << 5)
    qp = torch.from_numpy(rng.integers(20, 52, (1, h4, w4)).astype(np.int8)).to(DEV)
    bo = torch.from_numpy((2 * rng.integers(-3, 4, (1, h4, w4))).astype(np.int8)).to(DEV)
    to = torch.from_numpy((2 * rng.integers(-3, 4, (1, h4, w4))).astype(np.int8)).to(DEV)
    ctc = rng.integers(0, 25, (1, h4, w4)) << (bd - 8)
    ctc = torch.from_numpy(np.where(bs == 2, ctc, 0).astype(
        np.int16 if wide else np.uint8)).to(DEV)
    luma = torch.from_numpy(_smooth_plane(rng, (H, W), bd)).to(DEV)
    chroma = torch.from_numpy(_smooth_plane(rng, (H >> sy, W >> sx), bd)) \
        .to(DEV)
    chroma_name = "deblock_chroma16" if wide else "deblock_chroma"
    out = {chroma_name: Result()}
    if with_luma and not wide:
        out["deblock_luma"] = Result()
    for vertical in (True, False):
        d = "V" if vertical else "H"
        m = bsn_np.copy()
        # picture-edge entries carry bs 0, as compute_bs_maps leaves them
        if vertical:
            m[:, :, 0] &= ~np.uint8(3)
        else:
            m[:, 0, :] &= ~np.uint8(3)
        bsn = torch.from_numpy(m).to(DEV)
        for name, plane, run, plain, nmap in (
                ("deblock_luma", luma,
                 lambda p: DK.deblock_luma(p, bsn, qp, bo, to,
                                           vertical=vertical, bd=bd),
                 lambda p: DK.deblock_luma_plain(p, bsn, qp, bo, to,
                                                 vertical=vertical, bd=bd),
                 4),
                (chroma_name, chroma,
                 lambda p: DK.deblock_chroma(p, ctc, bsn, vertical=vertical,
                                             bd=bd, ssx=sx, ssy=sy),
                 lambda p: DK.deblock_chroma_plain(p, ctc, bsn,
                                                   vertical=vertical, bd=bd,
                                                   ssx=sx, ssy=sy),
                 1 + ctc.element_size())):
            if name not in out:
                continue
            got, want = plane.clone(), plane.clone()
            run(got)
            plain(want)
            torch.cuda.synchronize()
            e = max_abs_err(got, want)
            changed = int((want != plane).sum())
            scratch = plane.clone()
            bms = cuda_ms(lambda: run(scratch), 20)
            pms = cuda_ms(lambda: plain(scratch), 3)
            log(f"K3 {name} {d} {tuple(plane.shape[1:])} bd={bd}: mismatches="
                f"{int((got != want).sum())} (samples changed {changed}) "
                f"kernel {bms:.4f} ms, plain {pms:.4f} ms ({card})")
            # the plane read and written in place (int32), the per-4x4 maps
            # (bytes each); ~16 operations per sample for the decisions and
            # filters
            n = plane.numel()
            out[name].add(e, bms, pms, n * 8 + h4 * w4 * nmap, n * 16)
    return out


def check_k10(card, rng, B=2, H=1088, W=1920, depths=((8, 12), (12, 8))):
    """Row 11, K1's CCP epilogue, on a 1080p 4:4:4 chroma level
    (tests/ccp_cases.py): two 1920x1088 pictures, every 32x32 cell tiled
    with TUs of one size (flat, transform skip, bypass with RDPCM, CCP-only
    rows with zero coefficients), an alpha on every TU of 30% of the cells
    (every size and alpha), the luma residual over the whole int16 range so
    the clip acts.  One launch, 20 times bit-identical, against
    residual_table_plain and against the table without alphas followed by
    ccp_apply_plain (what the parent's K1 + K10 computed); timed with and
    without its alphas.  Then, at each (BitDepthY, BitDepthC) of `depths`,
    a level of the same kind at the chroma depth, its luma residual scaled
    by H.265 8.6.6: 20 launches bit-identical to the plain version, timed
    beside the same table launched at equal depths; the errors join."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from ccp_cases import ccp_level
    from libhm_tpu_torch.ops import ccp as CK
    from libhm_tpu_torch.ops import transform as TK
    from libhm_tpu_torch.parallel import batch_decode as TB
    lv = ccp_level(rng, TK.TU_DTYPE, B, H, W, share=0.3)
    rows = lv["rows"].copy()
    rows["rdpcm"] |= TK.ccp_bits(lv["alpha"])
    rows["flags"] |= np.where(lv["alpha"] != 0, TK.F_CCP, 0).astype(np.uint8)
    table, bare = TB.upload_tables(
        [(rows, lv["coeffs"], lv["counts"],
          int(np.bitwise_or.reduce(rows["flags"]))),
         (lv["rows"], lv["coeffs"], lv["counts"], lv["flags"])], DEV)
    res_l = torch.from_numpy(lv["res_l"]).to(DEV)
    tus = torch.from_numpy(lv["tus"]).to(DEV)

    def zeros():
        return torch.zeros((B, H, W), dtype=torch.int32, device=DEV)
    want = TK.residual_table_plain(zeros(), table, res_l=res_l)
    two = CK.ccp_apply_plain(TK.residual_table_plain(zeros(), bare), res_l,
                             tus)
    e = max_abs_err(want, two)
    changed = int((two != TK.residual_table_plain(zeros(), bare)).sum())
    got = zeros()
    n0 = TK._K1_CCP.launches
    for _ in range(20):
        got.zero_()
        TK.residual_table(got, table, res_l=res_l)
        torch.cuda.synchronize()
        e = max(e, max_abs_err(got, want))
    if TK._K1_CCP.launches != n0 + 20:
        raise AssertionError("K1 with CCP rows: launches not counted")

    def with_ccp():
        TK.residual_table(got, table, res_l=res_l)

    def without():
        TK.residual_table(got, bare)
    # each twice, in turns: with, without, without, with
    bms, b0ms, b0ms2, bms2 = (cuda_ms(f, 20) for f in (with_ccp, without,
                                                       without, with_ccp))
    dms, d0ms, d0ms2, dms2 = (device_ms(f, 20) for f in (with_ccp, without,
                                                         without, with_ccp))
    pms = cuda_ms(lambda: TK.residual_table_plain(got, table, res_l=res_l),
                  3)
    n = 1 << lv["rows"]["log2n"].astype(np.int64)
    on = lv["alpha"] != 0
    ccp_samples = int((n[on] ** 2).sum())
    sizes = {int(k): int((n[on] == k).sum()) for k in (4, 8, 16, 32)}
    nbytes, ops = _k1_work(rows)
    nbytes += ccp_samples * 4           # the luma residual at CCP samples
    ops += ccp_samples * 4              # multiply, shift, add, clip
    log(f"K1 CCP epilogue {(B, H, W)}: {len(rows)} TUs, {int(on.sum())} with "
        f"an alpha {sizes} over {ccp_samples} samples "
        f"({ccp_samples / (B * H * W):.1%} of the area), alphas "
        f"{sorted(set(lv['tus'][:, 4].tolist()))}: 20 launches, max abs err "
        f"{e} ({changed} samples changed by CCP); enqueue rate: with "
        f"alphas {bms:.4f} / {bms2:.4f} ms, "
        f"without {b0ms:.4f} / {b0ms2:.4f} ms; device time (queued behind a "
        f"sleep): with {dms:.4f} / {dms2:.4f} ms, without {d0ms:.4f} / "
        f"{d0ms2:.4f} ms, the epilogue adds "
        f"{(dms + dms2 - d0ms - d0ms2) / 2:.4f} ms; its extra bytes "
        f"{ccp_samples * 4} ({ccp_samples * 4 / HBM_BPS * 1e3:.5f} ms at "
        f"3.35 TB/s); plain {pms:.4f} ms ({card})")
    r = Result()
    r.add(e, bms, pms, nbytes, ops)
    for bdy, bdc in depths:
        r.err = max(r.err, _k10_depths(card, rng, B, H, W, bdy, bdc))
    return r


def _k10_depths(card, rng, B, H, W, bdy, bdc):
    """K1's CCP epilogue at luma bdy / chroma bdc bits (check_k10)."""
    import numpy as np
    import torch
    from ccp_cases import ccp_level
    from libhm_tpu_torch.ops import ccp as CK
    from libhm_tpu_torch.ops import transform as TK
    from libhm_tpu_torch.parallel import batch_decode as TB
    lv = ccp_level(rng, TK.TU_DTYPE, B, H, W, share=0.3, bd=bdc)
    rows = lv["rows"].copy()
    rows["rdpcm"] |= TK.ccp_bits(lv["alpha"])
    rows["flags"] |= np.where(lv["alpha"] != 0, TK.F_CCP, 0).astype(np.uint8)
    table, bare = TB.upload_tables(
        [(rows, lv["coeffs"], lv["counts"],
          int(np.bitwise_or.reduce(rows["flags"]))),
         (lv["rows"], lv["coeffs"], lv["counts"], lv["flags"])], DEV)
    res_l = torch.from_numpy(lv["res_l"]).to(DEV)
    tus = torch.from_numpy(lv["tus"]).to(DEV)
    bd = (bdy, bdc)

    def zeros():
        return torch.zeros((B, H, W), dtype=torch.int32, device=DEV)
    want = TK.residual_table_plain(zeros(), table, res_l=res_l, ccp_bd=bd)
    two = CK.ccp_apply_plain(TK.residual_table_plain(zeros(), bare), res_l,
                             tus, ccp_bd=bd)
    e = max_abs_err(want, two)
    scaled = int((want != TK.residual_table_plain(zeros(), table,
                                                  res_l=res_l)).sum())
    if not scaled:
        raise AssertionError(f"K1 CCP at {bd}: the scale changes nothing")
    got = zeros()
    for _ in range(20):
        got.zero_()
        TK.residual_table(got, table, res_l=res_l, ccp_bd=bd)
        torch.cuda.synchronize()
        e = max(e, max_abs_err(got, want))

    def at(depths):
        return lambda: TK.residual_table(got, table, res_l=res_l,
                                         ccp_bd=depths)
    # the same table at unequal and at equal depths, in turns
    dms, ems, ems2, dms2 = (device_ms(at(d), 20)
                            for d in (bd, (bdc, bdc), (bdc, bdc), bd))
    log(f"K1 CCP epilogue at luma {bdy} / chroma {bdc} bits {(B, H, W)}: "
        f"{len(rows)} TUs, {int((lv['alpha'] != 0).sum())} with an alpha: "
        f"20 launches, max abs err {e} against residual_table_plain and "
        f"ccp_apply_plain ({scaled} samples differ from the unscaled "
        f"formula); device time (queued behind a sleep) {dms:.4f} / "
        f"{dms2:.4f} ms, the same table at equal depths {ems:.4f} / "
        f"{ems2:.4f} ms ({card})")
    return e


def check_k4(card, rng, bd=10, sx=1, sy=1, with_luma=True):
    """K4 on a 1920x1088 luma plane (unless with_luma=False) and a chroma
    plane shifted by (sx, sy), with 64x64 luma CTBs: 960x544 in 4:2:0,
    960x1088 with 32x64 chroma CTBs (log2cx != log2cy) in 4:2:2."""
    import numpy as np
    import torch
    from libhm_tpu_torch.ops import sao as SK
    r = Result()
    planes = [(1088 >> sy, 1920 >> sx, 1080 >> sy, 1920 >> sx, 6 - sx, 6 - sy)]
    if with_luma:
        planes.insert(0, (1088, 1920, 1080, 1920, 6, 6))
    for (Hp, Wp, H, W, log2cx, log2cy) in planes:
        hc = (Hp + (1 << log2cy) - 1) >> log2cy
        wc = (Wp + (1 << log2cx) - 1) >> log2cx
        plane = torch.from_numpy(rng.integers(
            0, 1 << bd, (1, Hp, Wp)).astype(np.int32)).to(DEV)
        t = torch.from_numpy(rng.integers(-1, 5, (1, hc, wc)).astype(np.int8)).to(DEV)
        b = torch.from_numpy(rng.integers(0, 32, (1, hc, wc)).astype(np.int8)).to(DEV)
        o = torch.from_numpy(rng.integers(-31, 32, (1, hc, wc, 4)).astype(np.int8)).to(DEV)
        scale = torch.zeros(1, dtype=torch.int32, device=DEV)
        kw = dict(log2cx=log2cx, log2cy=log2cy, bd=bd, W=W, H=H)
        got = SK.sao(plane, t, b, o, scale, **kw)
        want = SK.sao_plain(plane, t, b, o, scale, **kw)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        bms = cuda_ms(lambda: SK.sao(plane, t, b, o, scale, **kw), 20)
        pms = cuda_ms(lambda: SK.sao_plain(plane, t, b, o, scale, **kw), 3)
        log(f"K4 sao_apply {(Hp, Wp)} CTB {1 << log2cx}x{1 << log2cy}: "
            f"mismatches={int((got != want).sum())} "
            f"kernel {bms:.4f} ms, plain {pms:.4f} ms ({card})")
        # the plane in and a new plane out (int32), 6 bytes of map per CTB;
        # ~20 operations per sample
        r.add(e, bms, pms, plane.numel() * 8 + hc * wc * 6,
              plane.numel() * 20)
    return r


def check_k4_multi(items, card, rng, bd=10):
    """K4's multi form on 1920x1088 luma and 960x544 chroma planes, with
    the tool stream's own slice, loop-filter-across and tile maps."""
    import numpy as np
    import torch
    from libhm_tpu_torch.ops import sao as SK
    from libhm_tpu_torch.parallel.device_filters import prepare_filter_maps
    it = items[-1]
    sps = it["sps"]
    m = prepare_filter_maps(it["pic"], sps, it["pps"], it["tile_map"])
    hc, wc, log2_ctb = sps.pic_height_ctbs, sps.pic_width_ctbs, sps.log2_ctb
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)[None]).to(DEV)  # noqa
    s4, lf4 = t(m["s4"]), t(m["lf4"].astype(np.uint8))
    tm = t(m["tm"].reshape(hc, wc))
    lft = torch.tensor([int(it["pps"].loop_filter_across_tiles)],
                       dtype=torch.uint8, device=DEV)
    r = Result()
    for (Hp, Wp, H, W, sh) in ((1088, 1920, 1080, 1920, 0),
                               (544, 960, 540, 960, 1)):
        plane = t(rng.integers(0, 1 << bd, (Hp, Wp)).astype(np.int32))
        typ = t(rng.integers(-1, 5, (hc, wc)).astype(np.int8))
        band = t(rng.integers(0, 32, (hc, wc)).astype(np.int8))
        offs = t(rng.integers(-31, 32, (hc, wc, 4)).astype(np.int8))
        scale = torch.zeros(1, dtype=torch.int32, device=DEV)
        kw = dict(log2cx=log2_ctb - sh, log2cy=log2_ctb - sh, bd=bd, W=W,
                  H=H, sx=sh, sy=sh, log2_ctb=log2_ctb)
        args = (plane, typ, band, offs, scale, s4, lf4, tm, lft)
        got = SK.sao_multi(*args, **kw)
        want = SK.sao_multi_plain(*args, **kw)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        bms = cuda_ms(lambda: SK.sao_multi(*args, **kw), 20)
        pms = cuda_ms(lambda: SK.sao_multi_plain(*args, **kw), 3)
        log(f"K4 sao_apply_multi {(Hp, Wp)} slices "
            f"{int(m['s4'].max()) + 1}, tiles {int(m['tm'].max()) + 1}: "
            f"mismatches={int((got != want).sum())} kernel {bms:.4f} ms, "
            f"plain {pms:.4f} ms ({card})")
        # the plane in and out (int32), 6 bytes of SAO map per CTB, the
        # slice/loop-filter maps (3 bytes per 4x4) and the tile map; ~30
        # operations per sample (the pairwise rules on top of K4's 20)
        r.add(e, bms, pms, plane.numel() * 8 + hc * wc * 8 +
              s4.numel() * 3, plane.numel() * 30)
    return r


def _lf_work(planes, maps, kw):
    """(bytes, operations) of one loop-filter level: every plane read and
    a new one written (int32), every map the mask reads once; ~40
    integer operations per sample for the two edge passes and SAO."""
    from libhm_tpu_torch.ops import loopfilter as LF
    n = sum(p.numel() for p in planes)
    read = {"bsn", "qp", "bo", "to", "ctc"} if kw["mask"] & (
        LF.PASS_V | LF.PASS_H) else set()
    if kw["mask"] & LF.PASS_SAO:
        read |= {"sao", "s4", "lf4", "tm", "lft"}
    nmap = sum(t.numel() * t.element_size() for k, t in maps.items()
               if k.split("_")[0] in read)
    return n * 8 + nmap, n * 40


def _lf_case(label, planes, maps, kw, card, r, reps=20, time_it=True):
    """The level kernel against its plain version: `reps` launches, each
    bit-identical to the plain result; timed at the host's enqueue rate
    and queued behind a sleep (device time).  Adds to Result r."""
    import torch
    from libhm_tpu_torch.ops import loopfilter as LF
    want = LF.loop_filter_level_plain(planes, maps, **kw)
    err = bad = 0
    for _ in range(reps):
        got = LF.loop_filter_level(planes, maps, **kw)
        torch.cuda.synchronize()
        err = max([err] + [max_abs_err(g, w) for g, w in zip(got, want)])
        bad += sum(int((g != w).sum()) for g, w in zip(got, want))
    changed = sum(int((w != p).sum()) for w, p in zip(want, planes))
    nbytes, ops = _lf_work(planes, maps, kw)
    ms = dms = pms = 0.0
    if time_it:
        ms = cuda_ms(lambda: LF.loop_filter_level(planes, maps, **kw), 20)
        dms = device_ms(lambda: LF.loop_filter_level(planes, maps, **kw), 20)
        pms = cuda_ms(lambda: LF.loop_filter_level_plain(planes, maps, **kw),
                      2)
    shapes = [tuple(p.shape) for p in planes]
    log(f"loop_filter_level {label} {shapes} mask={kw['mask']} "
        f"multi={kw['multi']} bd={kw['bd_l']}/{kw['bd_c']}: {reps} launches,"
        f" mismatches={bad} (samples changed {changed}); "
        + (f"kernel {ms:.4f} ms (device, queued behind a sleep: {dms:.4f} "
           f"ms), plain {pms:.4f} ms; " if time_it else "")
        + f"bound: bytes {nbytes / HBM_BPS * 1e3:.6f} ms ({nbytes} bytes), "
        f"operations {ops / CORE_OPS * 1e3:.6f} ms ({card})")
    if time_it:
        r.add(err, ms, pms, nbytes, ops)
    else:
        r.err = max(r.err, err)
    return ms, dms, nbytes


def _lf_real(items, rng):
    """(planes, maps, kw) of one level of a stream for the loop-filter
    level kernel: the decode's own maps, seeded smooth planes."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from lf_cases import smooth_planes
    from libhm_tpu_torch.parallel import device_filters as DF
    sps = items[0]["sps"]
    maps, kw, _ = DF.level_maps(items, sps, len(items), DEV)
    Hp = sps.pic_height_ctbs << sps.log2_ctb
    Wp = sps.pic_width_ctbs << sps.log2_ctb
    planes = [torch.from_numpy(smooth_planes(
        rng, (len(items), Hp >> (kw["sy"] if c else 0),
              Wp >> (kw["sx"] if c else 0)),
        kw["bd_c"] if c else kw["bd_l"])).to(DEV)
        for c in range(3 if sps.chroma_format_idc else 1)]
    return planes, maps, kw


def check_lf(ra_levels, tool_levels, card, rng):
    """The loop-filter level kernel (K3 + K4, one launch per level) against
    loop_filter_level_plain: the RA stream's largest level (3 pictures at
    1080p, the decode's own maps, seeded smooth planes) is the kernel's
    line; then the RA stream's first picture alone beside the nine
    single-pass launches that filter it the per-pass way; the tool
    stream's multi-slice/tile maps; and seeded levels (tests/lf_cases.py):
    12-bit chroma (int16 tc), 4:2:2, 4:4:4, SAO off, a one-CTA grid.
    Returns (level Result, one-picture Result)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from lf_cases import level_case
    from libhm_tpu_torch.ops import deblock as DK
    from libhm_tpu_torch.ops import sao as SK
    r, pic = Result(), Result()
    level = max(ra_levels, key=len)
    _lf_case(f"RA level ({len(level)} pictures)", *_lf_real(level, rng),
             card, r)
    # one picture, V + H + SAO of its three components: one launch, and
    # the nine single-pass launches (V and H per component, SAO per
    # component) on the same inputs
    planes, maps, kw = _lf_real(ra_levels[0][:1], rng)
    ms, dms, nbytes = _lf_case("RA picture 0 (one launch)", planes, maps,
                               kw, card, pic)
    hc, wc = kw["hc"], kw["wc"]
    per = [{t: maps[f"ctc_{t}"][:, c].contiguous() for t in "vh"}
           for c in range(2)]
    sao = [tuple(maps[k][:, :, c].reshape((1, hc, wc) + (4,) * (k == "sao_o"))
                 .contiguous() for k in ("sao_t", "sao_b", "sao_o"))
           for c in range(3)]
    scratch = [p.clone() for p in planes]

    def nine():
        for t, vertical in (("v", True), ("h", False)):
            DK.deblock_luma(scratch[0], maps[f"bsn_{t}"], maps[f"qp_{t}"],
                            maps.get(f"bo_{t}"), maps.get(f"to_{t}"),
                            vertical=vertical, bd=kw["bd_l"])
            for c in (1, 2):
                DK.deblock_chroma(scratch[c], per[c - 1][t], maps[f"bsn_{t}"],
                                  vertical=vertical, bd=kw["bd_c"],
                                  ssx=kw["sx"], ssy=kw["sy"])
        for c in range(3):
            s = (kw["sx"], kw["sy"]) if c else (0, 0)
            SK.sao(scratch[c], *sao[c],
                   maps["sao_scale_c" if c else "sao_scale_l"],
                   log2cx=kw["log2_ctb"] - s[0], log2cy=kw["log2_ctb"] - s[1],
                   bd=kw["bd_c"] if c else kw["bd_l"], W=kw["W"] >> s[0],
                   H=kw["H"] >> s[1])
    nine_ms = cuda_ms(nine, 20)
    nine_dev = device_ms(nine, 20)
    log(f"one 1080p picture, V + H + SAO of its three components: ONE "
        f"loop_filter_level launch {ms:.4f} ms at the enqueue rate, "
        f"{dms:.4f} ms device time; the nine single-pass launches (each "
        f"deblocking one copied back in place) {nine_ms:.4f} ms, "
        f"{nine_dev:.4f} ms device time; byte bound "
        f"{nbytes / HBM_BPS * 1e3:.6f} ms ({card})")
    tool = max(tool_levels, key=len)
    _lf_case(f"tools level ({len(tool)} pictures, multi-slice/tile SAO)",
             *_lf_real(tool, rng), card, r, time_it=False)
    for label, args in (
            ("12-bit chroma (int16 tc)",
             dict(Hp=1088, Wp=1920, H=1080, W=1920, bd_l=12, log2_ctb=6)),
            ("4:2:2", dict(Hp=1088, Wp=1920, H=1080, W=1920, chroma=2,
                           bd_l=10, log2_ctb=6)),
            ("4:4:4", dict(Hp=1088, Wp=1920, H=1080, W=1920, chroma=3,
                           bd_l=10, log2_ctb=6)),
            ("SAO off", dict(Hp=1088, Wp=1920, H=1080, W=1920, bd_l=10,
                             log2_ctb=6, sao=False)),
            ("one-CTA grid", dict(Hp=32, Wp=32, H=28, W=24, chroma=0,
                                  log2_ctb=5))):
        _lf_case(label, *level_case(rng, device=DEV, **args), card, r,
                 time_it=False)
    return r, pic


def check_k8(card, rng, B=3, bd=10):
    """K8 on a level of three 1920x1088 luma and 960x544 chroma planes of
    `bd`-bit samples with a seeded restore mask (one 4x4 in ten), against
    its plain version and torch.where (the mask expanded to samples
    beforehand, not timed)."""
    import numpy as np
    import torch
    from libhm_tpu_torch.ops import pcm as PK
    h4, w4 = 1088 // 4, 1920 // 4
    rmask_np = (rng.random((B, h4, w4)) < 0.1).astype(np.uint8)
    rmask = torch.from_numpy(rmask_np).to(DEV)
    r = Result()
    lib = 0.0
    for Hp, Wp, sh in ((1088, 1920, 0), (544, 960, 1)):
        planes = torch.from_numpy(rng.integers(0, 1 << bd, (B, Hp, Wp))
                                  .astype(np.int32)).to(DEV)
        pre = torch.from_numpy(rng.integers(0, 1 << bd, (B, Hp, Wp))
                               .astype(np.int32)).to(DEV)
        got, want = planes.clone(), planes.clone()
        PK.restore_unfiltered(got, pre, rmask, sx=sh, sy=sh)
        PK.restore_unfiltered_plain(want, pre, rmask, sx=sh, sy=sh)
        ys = torch.clamp((torch.arange(Hp, device=DEV) << sh) >> 2, max=h4 - 1)
        xs = torch.clamp((torch.arange(Wp, device=DEV) << sh) >> 2, max=w4 - 1)
        mask = rmask[:, ys[:, None], xs[None, :]] != 0
        lib_out = torch.where(mask, pre, planes)
        torch.cuda.synchronize()
        e = max(max_abs_err(got, want), max_abs_err(got, lib_out))
        scratch = planes.clone()
        bms = cuda_ms(lambda: PK.restore_unfiltered(scratch, pre, rmask,
                                                    sx=sh, sy=sh), 20)
        pms = cuda_ms(lambda: PK.restore_unfiltered_plain(
            scratch, pre, rmask, sx=sh, sy=sh), 5)
        lms = cuda_ms(lambda: torch.where(mask, pre, planes), 20)
        lib += lms
        dev_k = device_ms(lambda: PK.restore_unfiltered(
            scratch, pre, rmask, sx=sh, sy=sh), 20)
        dev_l = device_ms(lambda: torch.where(mask, pre, planes), 20)
        masked = int(mask.sum())
        log(f"K8 restore_unfiltered {(Hp, Wp)} B={B} bd={bd} masked samples "
            f"{masked}: mismatches={int((got != want).sum())} kernel "
            f"{bms:.4f} ms, plain {pms:.4f} ms, torch.where on the expanded "
            f"mask (expansion not timed) {lms:.4f} ms; queued behind a "
            f"sleep (device time): kernel {dev_k:.4f} ms, torch.where "
            f"{dev_l:.4f} ms ({card})")
        # the mask (one byte per 4x4), and at masked samples one int32 read
        # and one written; ~8 operations per sample for the index and test
        r.add(e, bms, pms, rmask.numel() + masked * 8, planes.numel() * 8)
    r.library_ms = lib
    return r


def check_k9(card, rng, bd=10, shifts=(2, 3)):
    """K9 on a seeded 1080p 4:2:0 level (tests/pcm_cases.py): one picture,
    a PCM CU of 8, 16 or 32 luma samples in about a third of the 32x32
    cells, luma and chroma shifted by `shifts` (bit depth - PCM bit
    depth), its luma and both chroma planes in ONE launch: against its
    plain version, at the enqueue rate and as device time queued behind a
    sleep, beside the byte bound; then a 4:2:2 level (w x 2w chroma
    blocks), against its plain version."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from libhm_tpu_torch.ops import pcm as PK
    from pcm_cases import pcm_blocks, plane_shapes
    r = Result()
    for fmt in (1, 2):
        blocks = pcm_blocks(rng, fmt, 1, 1088, 1920, share=1 / 3,
                            shifts=shifts, bd=bd)
        shapes = plane_shapes(fmt, 1, 1088, 1920)
        buf, counts = PK.pcm_pack(blocks)
        table = PK.pcm_table(torch.from_numpy(buf).to(DEV), counts)

        def zeros():
            return [torch.zeros(sh, dtype=torch.int32, device=DEV)
                    for sh in shapes]
        want = PK.pcm_level_plain(zeros(), table)
        got = zeros()
        n0 = PK._K9.launches
        PK.pcm_level(got, table)
        torch.cuda.synchronize()
        if PK._K9.launches != n0 + 1:
            raise AssertionError("K9: not one launch for the level")
        e = max(max_abs_err(g, w) for g, w in zip(got, want))
        samples = sum(w * h for _, _, _, _, w, h, _, _ in blocks)
        top = max(int(s.max()) << sh for *_, sh, s in blocks)
        label = f"K9 pcm_level {('', '4:2:0', '4:2:2')[fmt]} {shapes} " \
            f"bd={bd} (largest sample {top}): {len(blocks)} blocks (area classes {counts}), {samples} " \
            f"samples: max abs err {e}"
        if fmt == 2:
            r.err = max(r.err, e)
            log(f"{label} ({card})")
            continue
        bms = cuda_ms(lambda: PK.pcm_level(got, table), 20)
        dms = device_ms(lambda: PK.pcm_level(got, table), 20)
        pms = cuda_ms(lambda: PK.pcm_level_plain(got, table), 3)
        # int16 samples in, int32 samples out, each row once; a shift and
        # the addressing, ~6 operations a sample
        nbytes = samples * 6 + len(blocks) * 16
        log(f"{label}; one launch {bms:.4f} ms at the enqueue rate, device "
            f"time (queued behind a sleep) {dms:.4f} ms, byte bound "
            f"{nbytes / HBM_BPS * 1e3:.6f} ms ({nbytes} bytes at 3.35 TB/s);"
            f" plain {pms:.4f} ms ({card})")
        r.add(e, bms, pms, nbytes, samples * 6)
    return r


def _mc_list_ops(frac_x, frac_y, used, taps):
    """Integer operations of one list's 14-bit prediction per sample:
    2 per multiply-add of its filter case (copy, h or v only, h then v)
    plus the shifts and offsets; 0 where the list is unused."""
    import torch
    macs = torch.where(frac_x & frac_y, taps * taps + taps,
                       torch.where(frac_x | frac_y, taps, 0))
    return torch.where(used, 2 * macs + 4, 0)


# 1080p level shapes of the RA stream: 3 pictures, 4 reference pictures
LEVEL_B, LEVEL_R = 3, 4
COMPS = ((True, 0, 0, 1088, 1920, 1080, 1920),      # is_luma, sx, sy, Hp,
         (False, 1, 1, 544, 960, 540, 960))         # Wp, H, W
# the chroma planes of the same level in 4:2:2 (2x4 blocks, 1/8 pel across
# and 1/4 down) and 4:4:4 (4-tap, 1/4 pel both ways)
REXT_COMPS = ((False, 1, 0, 1088, 960, 1080, 960),
              (False, 0, 0, 1088, 1920, 1080, 1920))


def _mc_inputs(rng, bd, Hp, Wp, H, W, B=LEVEL_B):
    """Seeded level inputs: planes, references, per-4x4 maps.  One MV in
    twenty points far outside the picture (up to 1000 luma samples)."""
    import numpy as np
    import torch
    R = LEVEL_R
    h4, w4 = COMPS[0][3] // 4, COMPS[0][4] // 4
    mv = rng.integers(-64, 65, (B, h4, w4, 2, 2))
    far = rng.random((B, h4, w4, 2, 2)) < 0.05
    mv = np.where(far, rng.integers(-4000, 4001, mv.shape), mv)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
    return (t(rng.integers(0, 1 << bd, (B, Hp, Wp)).astype(np.int32)),
            t(rng.integers(-256, 257, (B, Hp, Wp)).astype(np.int32)),
            t(rng.integers(0, 1 << bd, (R, H, W)).astype(np.int32)),
            t(mv.astype(np.int16)),
            t(rng.integers(0, 4, (B, h4, w4)).astype(np.int8)),
            t(rng.integers(0, R, (B, h4, w4, 2)).astype(np.int16)))


def check_k5(card, rng, bd=10, comps=COMPS, B=LEVEL_B):
    """K5 on a 1080p level of B pictures: by default luma 1920x1088 and
    4:2:0 chroma 960x544 planes."""
    import torch
    from libhm_tpu_torch.ops import interp as MK
    r = Result()
    for is_luma, sx, sy, Hp, Wp, H, W in comps:
        stacked, res, refs, mv, dirm, sel = _mc_inputs(rng, bd, Hp, Wp, H, W,
                                                       B)
        kw = dict(is_luma=is_luma, sx=sx, sy=sy, bd=bd, W=W, H=H)
        got, want = stacked.clone(), stacked.clone()
        MK.mc_grid(got, res, refs, mv, dirm, sel, **kw)
        MK.mc_grid_plain(want, res, refs, mv, dirm, sel, **kw)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        bms = cuda_ms(lambda: MK.mc_grid(got, res, refs, mv, dirm, sel,
                                         **kw), 20)
        dms = device_ms(lambda: MK.mc_grid(got, res, refs, mv, dirm, sel,
                                           **kw), 20)
        pms = cuda_ms(lambda: MK.mc_grid_plain(want, res, refs, mv, dirm,
                                               sel, **kw), 2)
        # what this data needs: the R reference planes, the residual read
        # and the output written at inter samples (int32), the maps
        lh4, lw4 = COMPS[0][5] // 4, COMPS[0][6] // 4      # picture cells
        d = dirm[:, :lh4, :lw4].long()
        per_cell = (4 >> sx) * (4 >> sy)
        inter = int((d > 0).sum()) * per_cell
        taps, fbx, fby = MK._filter_args(is_luma, sx, sy)
        mvc = mv[:, :lh4, :lw4].long()
        fx = (mvc[..., 0] & ((1 << fbx) - 1)) != 0
        fy = (mvc[..., 1] & ((1 << fby) - 1)) != 0
        ops = sum(_mc_list_ops(fx[..., l], fy[..., l],
                               (d & (1 << l)) != 0, taps)
                  for l in range(2)) + torch.where(d > 0, 8, 0)
        nbytes = refs.numel() * 4 + inter * 8 + dirm.numel() * 13
        log(f"K5 mc_grid {'luma' if is_luma else 'chroma'} {(Hp, Wp)} "
            f"sx={sx} sy={sy} bd={bd} "
            f"B={B} R={LEVEL_R} inter samples={inter}: mismatches="
            f"{int((got != want).sum())} kernel {bms:.4f} ms (device "
            f"{dms:.4f} ms), plain {pms:.4f} ms ({card})")
        r.add(e, bms, pms, nbytes, int(ops.sum()) * per_cell)
    return r


def _k6_work(blk, refs, is_luma, sx, sy):
    """(bytes, operations) of K6 on a block table: the reference planes,
    each block's residual read and samples written (int32) and the table;
    each list's filter (_mc_list_ops) and ~10 epilogue operations a
    sample."""
    from libhm_tpu_torch.ops import interp as MK
    per_blk = (4 >> sx) * (4 >> sy)
    taps, fbx, fby = MK._filter_args(is_luma, sx, sy)
    t = blk.long().cpu()
    ops = sum(_mc_list_ops((t[:, 4 + 2 * l] & ((1 << fbx) - 1)) != 0,
                           (t[:, 5 + 2 * l] & ((1 << fby) - 1)) != 0,
                           (t[:, 3] & (1 << l)) != 0, taps)
              for l in range(2)) + 10
    nbytes = refs.numel() * 4 + len(t) * per_blk * 8 + t.numel() * 4
    return nbytes, int(ops.sum()) * per_blk


def _k6_case(label, blk, planes, kw, card):
    """K6 on one block table, 20 launches each bit-identical to the plain
    version: with the rows as the decode hands them (luma grouped by tile
    beforehand; enqueue rate and device time) and as they come (luma
    grouped on the device; enqueue rate).  Returns (max error, ms, plain
    ms, bytes, operations)."""
    import torch
    from libhm_tpu_torch.ops import interp as MK
    stacked, res, refs = planes
    B, Hp, Wp = stacked.shape
    rows, groups = blk, None
    if kw["is_luma"]:
        rows, groups = MK.tile_groups(blk, B=B, Hp=Hp, Wp=Wp)
    want = stacked.clone()
    MK.mc_weighted_plain(want, res, refs, blk, **kw)
    err = 0
    got = stacked.clone()

    def run(table, grp):
        MK.mc_weighted(got, res, refs, table, groups=grp, **kw)
    for table, grp in ((rows, groups), (blk, None)):
        for _ in range(20):
            got.copy_(stacked)
            run(table, grp)
            torch.cuda.synchronize()
            err = max(err, max_abs_err(got, want))
    bms = cuda_ms(lambda: run(rows, groups), 20)
    dms = device_ms(lambda: run(rows, groups), 20)
    ams = cuda_ms(lambda: run(blk, None), 20)
    pms = cuda_ms(lambda: MK.mc_weighted_plain(want, res, refs, blk, **kw), 2)
    nbytes, ops = _k6_work(blk, refs, kw["is_luma"], kw["sx"], kw["sy"])
    # (run starts past the last row are padding)
    runs = "in any order" if groups is None else \
        f"in {int((groups < len(blk)).sum())} tile runs"
    epi = f"WP denom {kw['denom']}" if kw["wp"] else "plain epilogue"
    log(f"K6 mc_weighted {label} bd={kw['bd']}: {len(blk)} blocks {runs}, "
        f"{epi}: max error {err} over 20 launches a table; kernel "
        f"{bms:.4f} ms (device {dms:.4f} ms), rows as they come (luma "
        f"grouped on the device) {ams:.4f} ms, plain {pms:.4f} ms; bound "
        f"{max(nbytes / HBM_BPS, ops / CORE_OPS) * 1e3:.5f} ms ({card})")
    return err, bms, pms, nbytes, ops


def check_k6(card, rng, bd=10, denom=6, wp=True, hpo=False):
    """K6 (weighted epilogue, or with wp=False the plain uni / bi one) on
    every inter 4x4 of a 1080p level of random per-4x4 MVs (row 8), then
    on a PU-shaped 1080p level of 8x8 to 64x64 PUs (tests/mc_cases.py
    pu_maps), whose error joins the row's.  hpo: the per-4x4 level's
    offsets over the range of high_precision_offsets_enabled_flag,
    +-2^(bd - 1) unshifted (H.265 7.4.7.3), where they are else 8-bit
    offsets shifted by bd - 8."""
    import numpy as np
    import torch
    from libhm_tpu_torch.ops import interp as MK
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from mc_cases import block_table, pu_maps
    r = Result()
    maps = pu_maps(rng, LEVEL_B, LEVEL_R, COMPS[0][3], COMPS[0][4],
                   sizes=(16, 8, 4, 2))
    for is_luma, sx, sy, Hp, Wp, H, W in COMPS:
        stacked, res, refs, mv, dirm, sel = _mc_inputs(rng, bd, Hp, Wp, H, W)
        d = dirm[:, :COMPS[0][5] // 4, :COMPS[0][6] // 4].cpu().numpy()
        b, ys4, xs4 = np.nonzero(d)
        N = len(b)
        blk = np.zeros((N, len(MK.BLK_FIELDS)), np.int32)
        blk[:, 0], blk[:, 1], blk[:, 2] = b, (xs4 << 2) >> sx, (ys4 << 2) >> sy
        blk[:, 3] = d[b, ys4, xs4]
        blk[:, 4:8] = mv.cpu().numpy()[b, ys4, xs4].reshape(N, 4)
        blk[:, 8:10] = sel.cpu().numpy()[b, ys4, xs4]
        blk[:, 10:12] = rng.integers(-128, 256, (N, 2))
        if hpo:
            half = 1 << (bd - 1)
            blk[:, 12:14] = rng.integers(-half, half, (N, 2))
        else:
            blk[:, 12:14] = rng.integers(-128, 128, (N, 2)) << (bd - 8)
        kw = dict(is_luma=is_luma, sx=sx, sy=sy, bd=bd, wp=wp, denom=denom,
                  W=W, H=H)
        comp = f"{'luma' if is_luma else 'chroma'} {(Hp, Wp)}" + \
            (", high-precision offsets" if hpo else "")
        r.add(*_k6_case(f"{comp} per-4x4 MVs",
                        torch.from_numpy(blk).to(DEV), (stacked, res, refs),
                        kw, card))
        pu = torch.from_numpy(block_table(maps, sx, sy, bd, past=False))
        r.err = max(r.err, _k6_case(f"{comp} PUs 8x8-64x64", pu.to(DEV),
                                    (stacked, res, refs), kw, card)[0])
    return r


def check_k7(card, rng, npics=17, bd=10):
    """K7 over the cropped output planes of a 17-picture 1080p stream (51
    views, one launch), against its plain version and the library sum;
    nothing is uploaded."""
    import numpy as np
    import torch
    from libhm_tpu_torch.ops import checksum as CK
    from libhm_tpu_torch.utils import xfer
    r = Result()
    views = []
    for Hp, Wp, H, W in ((1088, 1920, 1080, 1920), (544, 960, 540, 960),
                         (544, 960, 540, 960)):
        planes = torch.from_numpy(rng.integers(
            0, 1 << bd, (npics, Hp, Wp)).astype(np.int32)).to(DEV)
        views += [planes[b, :H, :W] for b in range(npics)]
    xfer.reset()
    n0 = CK._K7.launches
    got = int(CK.plane_checksum(views).item()) & 0xFFFFFFFF
    launches = CK._K7.launches - n0
    if xfer.H2D or "checksum" in xfer.BY_TAG or launches != 1:
        raise AssertionError(f"K7: {launches} launches, uploads "
                             f"{xfer.BY_TAG}")
    want = int(CK.plane_checksum_plain(views).item())
    lib = [v.sum(dtype=torch.int64) for v in views]
    lib = int(sum(int(s.item()) for s in lib)) & 0xFFFFFFFF
    bms = cuda_ms(lambda: CK.plane_checksum(views), 20)
    dms = device_ms(lambda: CK.plane_checksum(views), 20)
    pms = cuda_ms(lambda: CK.plane_checksum_plain(views), 5)
    r.library_ms = cuda_ms(
        lambda: [v.sum(dtype=torch.int64) for v in views], 5)
    n = sum(v.numel() for v in views)
    log(f"K7 plane_checksum {len(views)} views, {n} samples of {bd} bits: "
        f"kernel {got}, "
        f"plain {want}, library {lib}; {launches} launch, no upload; kernel "
        f"{bms:.4f} ms (device {dms:.4f} ms), plain {pms:.4f} ms, "
        f"view.sum(dtype=torch.int64) per view {r.library_ms:.4f} ms "
        f"({card})")
    r.add(abs(got - want) + abs(got - lib), bms, pms, n * 4 + len(views) * 32,
          n)
    return r


def check_fused(card):
    """Row 16: entry()'s fused recon step at 1080p Main10 through K1, K6,
    the loop-filter kernel (V luma edges and SAO, one launch) and K7
    against the same step through the plain versions: the int32 sum and
    the frame exactly.  Returns (Result, launches per kernel of one
    step)."""
    import torch
    from libhm_tpu_torch import entry as E
    from libhm_tpu_torch.ops import checksum as CK
    from libhm_tpu_torch.ops import interp as MK
    from libhm_tpu_torch.ops import loopfilter as LF
    from libhm_tpu_torch.ops import transform as TK
    kern = {"residual_scatter": TK._K1, "mc_weighted": MK._K6,
            "loop_filter_level": LF._LF, "plane_checksum": CK._K7}
    fn, args = E.entry(device="cuda")
    before = {k: v.launches for k, v in kern.items()}
    s, f = fn(*args)
    torch.cuda.synchronize()
    launches = {k: v.launches - before[k] for k, v in kern.items()}
    if not all(launches.values()):
        raise AssertionError(f"fused step: kernels not launched {launches}")
    s_p, f_p = E.fused_recon_step_plain(*args)
    e = max(abs(int(s) - int(s_p)), max_abs_err(f, f_p))
    bms = cuda_ms(lambda: fn(*args), 20)
    pms = cuda_ms(lambda: E.fused_recon_step_plain(*args), 3)
    _, dev = device_events(lambda: fn(*args))
    (k6_ms, _), (k7_ms, _) = (dev_sum(dev, k) for k in (
        "mc_weighted", "checksum_kernel"))
    # every input read once, the frame and the sum written once; of the two
    # reference frames only what MC reads: each 16x16 block, on both lists,
    # reads a (16 + 7)^2 window of int32 samples
    refs = args[E.ARGS.index("refs")]
    nb16 = args[E.ARGS.index("sel")].numel()
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if a is not refs) + nb16 * 2 * 23 * 23 * 4 + \
        f.numel() * 4 + 4
    log(f"row 16 fused_recon_step (1088x1920, 256 16x16 + 1024 4x4 "
        f"blocks): sum {int(s)} (plain {int(s_p)}), frame mismatches "
        f"{int((f != f_p).sum())}; launches {launches}; kernel {bms:.4f} ms"
        f" (host-bound; device time of one step under torch.profiler: K6 "
        f"{k6_ms:.4f} ms, K7 {k7_ms:.4f} ms), plain {pms:.4f} ms, {nbytes} "
        f"bytes: bound "
        f"{nbytes / HBM_BPS * 1e3:.4f} ms ({card})")
    r = Result()
    r.add(e, bms, pms, nbytes, 0)
    return r, launches


def push_decode(data, sei_check=False):
    """Push a stream NAL by NAL through libhm_tpu_torch.api.HmDecoder (its
    defaults: native parse, recon="torch" on the card), re-pushing on a new
    picture and pulling every picture when told to.  Returns (decoder,
    pictures, seconds to the first pulled picture, total seconds)."""
    import torch
    from libhm_tpu_torch import api
    from libhm_tpu_torch.hostdec import nal as N
    dec = api.HmDecoder()
    dec.set_sei_check(sei_check)
    pics, first = [], None
    nals = list(N.split_annexb(data))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    i = 0
    while i < len(nals):
        new_pic, check = dec.push_nal_unit(nals[i], i == len(nals) - 1)
        if check:
            while True:
                p = dec.get_picture()
                if p is None:
                    break
                if first is None:
                    first = time.monotonic() - t0
                pics.append(p)
        if not new_pic:
            i += 1
    return dec, pics, first, time.monotonic() - t0


def pics_md5(pics):
    return hashlib.md5(b"".join(pl.tobytes() for p in pics
                                for pl in p.planes)).hexdigest()


def picture_main_path(data, gold, card, name=STREAM):
    """The per-picture main path: a golden stream (the RA 1080p one by
    default) pushed through HmDecoder and every picture pulled, timed per
    picture; golden MD5, no reference plane uploaded, peak device memory
    under the DPB's bound."""
    import torch
    import libhm_tpu_torch.recon_torch as RT
    from libhm_tpu_torch.utils import xfer
    recon_ms = []
    orig = RT.reconstruct_picture

    def timed(item, device):
        t = time.monotonic()
        out = orig(item, device)         # ends with the download
        recon_ms.append((time.monotonic() - t) * 1e3)
        return out
    xfer.reset()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    RT.reconstruct_picture = timed
    try:
        dec, pics, first, total = push_decode(data)
    finally:
        RT.reconstruct_picture = orig
    peak = torch.cuda.max_memory_allocated()
    md5 = pics_md5(pics)
    if len(pics) != gold[name]["frames"] or \
            md5 != gold[name]["decoded_yuv_md5"]:
        raise AssertionError(f"{name} through HmDecoder: {len(pics)} "
                             f"pictures, MD5 {md5}")
    sps = pics[0]._dp.sps
    dpb = sps.max_dec_pic_buffering[sps.max_sub_layers_minus1]
    Hp = sps.pic_height_ctbs << sps.log2_ctb
    Wp = sps.pic_width_ctbs << sps.log2_ctb
    pic_bytes = Hp * Wp * 4 * 3 // 2
    cap = (dpb + 3) * pic_bytes + (256 << 20)
    ref = xfer.BY_TAG.get("ref", 0)
    ms = sorted(recon_ms)
    log(f"{name} through HmDecoder ({card}): {len(pics)} pictures, MD5 "
        f"matches golden; first picture pulled after {first:.3f} s; "
        f"{len(pics) / total:.3f} fps over {total:.3f} s; recon per picture "
        f"median {ms[len(ms) // 2]:.1f} ms, max {ms[-1]:.1f} ms; H2D "
        f"{xfer.H2D / len(pics) / 1e6:.3f} MB/picture (ref {ref} bytes), "
        f"D2H {xfer.D2H / len(pics) / 1e6:.3f} MB/picture; peak device "
        f"memory {peak / 1e6:.1f} MB (before the run {base / 1e6:.1f} MB; "
        f"cap {cap / 1e6:.1f} MB = (DPB {dpb} + 3) x {pic_bytes / 1e6:.3f} "
        f"MB + 256 MiB); DPB at the end {len(dec._core.dpb)} pictures")
    if ref:
        raise AssertionError(f"{name}: {ref} bytes of reference planes "
                             "uploaded")
    if peak > cap:
        raise AssertionError(f"{name}: peak device memory {peak} over "
                             f"the cap {cap}")
    return len(pics)


def slot_bytes(rows, B):
    """H2D bytes of the blocks of a flat intra table in the per-size slot
    layout that one launch per (level, size) read: per size n, [B, L, K]
    slots of int16 x and y, int8 mode, uint8 flags and (4n+8)/8 bytes of
    availability, L the last level holding the size, K its fullest
    (picture, level)."""
    import numpy as np
    total = 0
    log2n = rows["nf"] & 15
    for l2 in np.unique(log2n):
        r = rows[log2n == l2]
        L = int(r["level"].max()) + 1
        K = int(np.unique(r["b"].astype(np.int64) << 32 | r["level"],
                          return_counts=True)[1].max())
        total += B * L * K * (6 + ((4 << int(l2)) + 8 >> 3))
    return total


def breakdown(data, card):
    """Where the RA recon time goes: host functions (cProfile) and the
    device kernel time and busy share (torch.profiler), one run each."""
    import cProfile
    import pstats
    import torch
    from libhm_tpu_torch.hostdec.decoder import Decoder
    from libhm_tpu_torch.parallel import batch_decode as TB
    from libhm_tpu_torch.parallel import dag_decode as DD
    cuda = torch.device("cuda")

    def items():
        dec = Decoder(parse="native", recon="collect")
        dec.decode_annexb(data)
        return dec.collected
    its = items()
    prof = cProfile.Profile()
    table_of = TB.intra_table
    sizes = [0, 0]

    def measured(items, comp):
        built = table_of(items, comp)
        if built is not None:
            sizes[0] += built[0].nbytes + built[1].nbytes
            sizes[1] += slot_bytes(built[0], len(items))
        return built
    TB.intra_table = measured
    torch.cuda.synchronize()
    t0 = time.monotonic()
    prof.enable()
    try:
        DD._recon_levels(its, [cuda])
        torch.cuda.synchronize()
    finally:
        prof.disable()
        TB.intra_table = table_of
    wall = time.monotonic() - t0
    log(f"breakdown: intra H2D {sizes[0]} bytes (the flat tables), against "
        f"{sizes[1]} bytes for the same blocks in per-(level, size) slots")
    log(f"breakdown ({card}): recon under cProfile {wall:.3f} s; "
        "cumulative host seconds per function (calls):")
    names = {"prepare_component", "residual_tables", "upload_tables",
             "residual_table", "_residual_planes_batch_device", "_intra_batch", "filter_level",
             "prepare_filter_maps", "compute_bs_maps", "residual_scatter",
             "intra_wavefront", "intra_table", "level_maps",
             "pack_filter_maps", "loop_filter_level", "up",
             "__call__", "_inter_level", "_inter_level_grid",
             "_inter_level_gathered", "_level_refs", "_ref_stack", "mc_grid",
             "mc_weighted", "reference_levels", "_recon_levels"}
    rows = [(ct, f"{os.path.basename(f)}:{fn}", nc)
            for (f, _, fn), (_, nc, _, ct, _)
            in pstats.Stats(prof).stats.items()
            if fn in names and "libhm_tpu_torch" in f]
    for ct, fn, nc in sorted(rows, reverse=True):
        log(f"  {fn:44s} {ct:8.3f} s  ({nc})")

    its = items()
    from libhm_tpu_torch.ops import interp as MK
    from libhm_tpu_torch.ops import loopfilter as LF
    from libhm_tpu_torch.ops import transform as TK
    TK._K1.launches = MK._K5.launches = LF._LF.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    _, dev = device_events(lambda: DD._recon_levels(its, [cuda]))
    wall = time.monotonic() - t0
    k1_k5 = (TK._K1.launches, MK._K5.launches, LF._LF.launches)
    total = sum(us for us, _ in dev.values())
    log(f"breakdown ({card}): recon under torch.profiler {wall:.3f} s; "
        f"device time (kernel, memcpy and memset events only) "
        f"{total / 1e3:.3f} ms, busy share {(total / 1e6) / wall:.2%}"
        if total else
        "device time: not measured (the profiler saw no device activity)")
    for key, (us, cnt) in sorted(dev.items(), key=lambda kv: -kv[1][0])[:14]:
        log(f"  {key[:60]:60s} {us / 1e3:9.3f} ms  ({cnt}) "
            f"{us / total:6.1%}")
    (k1_ms, k1_n), (k5_ms, k5_n), (lf_ms, lf_n), (h2d_ms, h2d_n) = (
        dev_sum(dev, k) for k in ("residual_table_kernel", "mc_grid_kernel",
                                  "loop_filter_kernel", "HtoD"))
    log(f"breakdown ({card}): K1 {k1_k5[0]} launches, {k1_ms:.3f} ms device "
        f"({k1_n} kernels seen); K5 {k1_k5[1]} launches, {k5_ms:.3f} ms "
        f"device ({k5_n} seen); loop filter (K3 + K4) {k1_k5[2]} launches, "
        f"{lf_ms:.4f} ms device ({lf_n} seen); H2D memcpy {h2d_n}, "
        f"{h2d_ms:.3f} ms device")


class LevelCapture:
    """The inputs that one decode hands K1 and K5 on its level with the
    most pictures (the first such), recorded by wrapping the two entry
    points while the decode runs: real coefficients, TU tables, MV /
    direction / reference maps and reference planes, no extra launch."""

    def __init__(self):
        from libhm_tpu_torch.ops import interp as MK
        from libhm_tpu_torch.ops import transform as TK
        self.MK, self.TK = MK, TK
        self.k1, self.k5 = TK.residual_table, MK.mc_grid
        self.cur = None
        self.best = {"B": 0, "res": [], "mc": []}
        TK.residual_table, MK.mc_grid = self._k1, self._k5

    def _k1(self, planes, table, mats=None, res_l=None, ccp_bd=None):
        if self.cur is None or len(self.cur["res"]) == 3:
            self.cur = {"B": planes.shape[0], "res": [], "mc": []}
            if self.cur["B"] > self.best["B"]:
                self.best = self.cur
        # (the RA stream is 4:2:0: no CCP rows, res_l is None)
        self.cur["res"].append((planes.shape, table, mats))
        return self.k1(planes, table, mats, res_l, ccp_bd)

    def _k5(self, stacked, res, refs, mv, dirm, sel, **kw):
        if self.cur is self.best:
            self.cur["mc"].append((stacked.clone(), res, refs, mv, dirm, sel,
                                   kw))
        return self.k5(stacked, res, refs, mv, dirm, sel, **kw)

    def remove(self):
        self.TK.residual_table, self.MK.mc_grid = self.k1, self.k5


def check_real_level(cap, card):
    """K1 and K5 against their plain versions on the captured level of the
    RA decode, timed: the decode's own coefficients and maps."""
    import torch
    MK, TK = cap.MK, cap.TK
    lv = cap.best
    if not lv["mc"]:
        raise AssertionError("real level: the captured level has no MC")
    err, t = 0, {"K1": [0.0, 0.0, 0.0], "K5": [0.0, 0.0, 0.0]}
    tus = inter = 0
    for shape, table, mats in lv["res"]:
        got = torch.zeros(shape, dtype=torch.int32, device=DEV)
        want = torch.zeros(shape, dtype=torch.int32, device=DEV)
        TK.residual_table(got, table, mats)
        TK.residual_table_plain(want, table, mats)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, want))
        t["K1"][0] += cuda_ms(lambda: TK.residual_table(got, table, mats), 20)
        t["K1"][2] += device_ms(lambda: TK.residual_table(got, table, mats),
                                20)
        t["K1"][1] += cuda_ms(lambda: TK.residual_table_plain(want, table,
                                                              mats), 3)
        tus += table.rows.shape[0]
    for stacked, res, refs, mv, dirm, sel, kw in lv["mc"]:
        got, want = stacked.clone(), stacked.clone()
        MK.mc_grid(got, res, refs, mv, dirm, sel, **kw)
        MK.mc_grid_plain(want, res, refs, mv, dirm, sel, **kw)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, want))
        t["K5"][0] += cuda_ms(lambda: MK.mc_grid(got, res, refs, mv, dirm,
                                                 sel, **kw), 20)
        t["K5"][2] += device_ms(lambda: MK.mc_grid(got, res, refs, mv, dirm,
                                                   sel, **kw), 20)
        t["K5"][1] += cuda_ms(lambda: MK.mc_grid_plain(want, res, refs, mv,
                                                       dirm, sel, **kw), 2)
        inter = int((dirm > 0).sum())
    log(f"real RA level ({lv['B']} pictures, {tus} TUs, {inter} inter 4x4 "
        f"cells, {refs.shape[0]} references; the decode's coefficients and "
        f"maps): K1 {len(lv['res'])} launches {t['K1'][0]:.4f} ms (device "
        f"{t['K1'][2]:.4f} ms; plain {t['K1'][1]:.4f} ms), K5 "
        f"{len(lv['mc'])} launches {t['K5'][0]:.4f} ms (device "
        f"{t['K5'][2]:.4f} ms; plain {t['K5'][1]:.4f} ms); max abs err "
        f"{err} ({card})")
    if err:
        raise AssertionError("real RA level: K1 or K5 differs from its "
                             "plain version")


# the single-pass K3/K4 entry points: no decode path launches them
SINGLE_PASS = ["deblock_luma", "deblock_chroma", "deblock_chroma16",
               "sao_apply", "sao_apply_multi"]
K1_K4 = ["residual_scatter", "intra_wavefront", "loop_filter_level"]


def kernel_counters():
    """(kernels, counters): each kernel entry point's launch counter by
    name, and the same with the level kernel's forms (counted with its
    launches)."""
    from libhm_tpu_torch.ops import checksum as CK
    from libhm_tpu_torch.ops import deblock as DK
    from libhm_tpu_torch.ops import interp as MK
    from libhm_tpu_torch.ops import intra as IK
    from libhm_tpu_torch.ops import loopfilter as LF
    from libhm_tpu_torch.ops import pcm as PK
    from libhm_tpu_torch.ops import sao as SK
    from libhm_tpu_torch.ops import transform as TK
    kernels = {"residual_scatter": TK._K1,
               "residual_scatter_scaled": TK._K1_SCAL,
               "residual_bypass": TK._K1_BYPASS, "intra_wavefront": IK._K2,
               "loop_filter_level": LF._LF,
               "deblock_luma": DK._K3_LUMA, "deblock_chroma": DK._K3_CHROMA,
               "sao_apply": SK._K4, "sao_apply_multi": SK._K4_MULTI,
               "mc_grid": MK._K5, "mc_weighted": MK._K6,
               "plane_checksum": CK._K7, "restore_unfiltered": PK._K8,
               "pcm_level": PK._K9, "deblock_chroma16": DK._K3_CHROMA16,
               "residual_table_ccp": TK._K1_CCP,
               "residual_table_ext": TK._K1_EXT}
    return kernels, dict(kernels, loop_filter_multi=LF.FORMS["multi"],
                         loop_filter_ctc16=LF.FORMS["ctc16"])


def run_path(label, fn, needed):
    """Run one main path with the launch counters from 0 and the
    reference-DAG levels it reconstructs counted, and the shards of them
    that run on the card (one per level on one device): every kernel of
    `needed` launched, K1 and K2 at most once per component and shard,
    the loop-filter kernel exactly once per shard and no single-pass
    K3/K4 entry point."""
    import torch
    from libhm_tpu_torch.parallel import dag_decode as DD
    counters = kernel_counters()[1]
    levels_of, shard_of = DD.reference_levels, DD._recon_shard
    seen, on_card = [], []

    def counted(items):
        out = levels_of(items)
        seen.append(len(out))
        return out

    def shard(items, sps0, device, download):
        on_card.append(device.type == "cuda")
        return shard_of(items, sps0, device, download)
    for k in counters.values():
        k.launches = 0
    DD.reference_levels, DD._recon_shard = counted, shard
    try:
        out = fn()
    finally:
        DD.reference_levels, DD._recon_shard = levels_of, shard_of
    torch.cuda.synchronize()
    counts = {nm: k.launches for nm, k in counters.items()}
    idle = [nm for nm in needed if counts[nm] == 0]
    if idle:
        raise AssertionError(f"{label}: kernels never launched: {idle}")
    n = sum(on_card)
    for k in ("intra_wavefront", "residual_scatter"):
        if counts[k] > 3 * n and n:
            raise AssertionError(f"{label}: {counts[k]} {k} launches over "
                                 f"{n} shards on the card")
    if n and (counts["loop_filter_level"] != n or
              any(counts[k] for k in SINGLE_PASS)):
        raise AssertionError(f"{label}: loop-filter launches {counts} over "
                             f"{n} shards on the card")
    log(f"{label}: {sum(seen)} DAG levels, {len(on_card)} shards ({n} on "
        f"the card), launches {counts}")
    return out, counts


def predicted_launches(items, m):
    """What a decode of collect `items` with m device entries launches,
    from the parse: each level splits into contiguous shards of
    ceil(B / m) pictures (sliced here, not by dag_decode._shards, so the
    count does not lean on the code under test), each making one K1
    launch per component with a TU, one K2 launch over every component
    where a picture has an intra block, one K5 launch per component where
    a picture has an inter PU (streams without WP) and one loop-filter
    launch.  Returns (launches by kernel name, shards, entries that get a
    picture)."""
    from libhm_tpu_torch.parallel import dag_decode as DD
    ncomp = 3 if items[0]["sps"].chroma_format_idc else 1
    want = dict.fromkeys(K1_K4 + ["mc_grid"], 0)
    shards, holders = 0, set()
    for lv in DD.reference_levels(items):
        per = -(-len(lv) // m)
        for k in range(-(-len(lv) // per)):
            pics = [it["pic"] for it in lv[k * per:(k + 1) * per]]
            shards += 1
            holders.add(k)
            want["residual_scatter"] += len({tu.comp for p in pics
                                             for tu in p.tu_list})
            want["intra_wavefront"] += any(p.intra_list for p in pics)
            want["mc_grid"] += ncomp * any(p.inter_list for p in pics)
            want["loop_filter_level"] += 1
    return want, shards, len(holders)


def outs_md5(outs):
    return hashlib.md5(b"".join(p.tobytes() for pic in outs
                                for p in pic)).hexdigest()


def multidevice_phase(gold, card):
    """The multi-device decode: devices= lists on the four whole-stream
    entry points, each level's pictures split into contiguous shards of
    ceil(B / m) over the m entries.  Two entries on one card, a mixed
    card + CPU list (references cross devices as counted peer copies),
    and, on a host with several cards, one entry per card; the launches
    of each split against predicted_launches, fps beside one device."""
    import torch
    from libhm_tpu_torch import entry
    from libhm_tpu_torch.hostdec.decoder import Decoder
    from libhm_tpu_torch.parallel import dag_decode as DD
    from libhm_tpu_torch.parallel.batch_decode import decode_intra_batch
    from libhm_tpu_torch.utils import xfer

    def read(name):
        return open(os.path.join(ROOT, "testdata", gold[name]["bitstream"]),
                    "rb").read()
    count = torch.cuda.device_count()
    data = read(STREAM)
    md5 = gold[STREAM]["decoded_yuv_md5"]
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(data)
    items = dec.collected
    del dec
    two = ["cuda:0", "cuda:0"]
    cards = [f"cuda:{i}" for i in range(count)]
    lists = [two] + ([cards] if count > 1 else [])

    for devs in lists:
        want, shards, holders = predicted_launches(items, len(devs))
        xfer.reset()
        outs, counts = run_path(
            f"{STREAM} decode_batch devices={devs}",
            lambda: DD.decode_batch(data, devices=devs),
            K1_K4 + ["mc_grid"])
        got = {k: counts[k] for k in want}
        if outs_md5(outs) != md5 or got != want:
            raise AssertionError(f"decode_batch devices={devs}: MD5 "
                                 f"{outs_md5(outs)}, launches {got}, "
                                 f"predicted {want}")
        peer = (xfer.UPLOADS.get("peer", 0), xfer.BY_TAG.get("peer", 0))
        if (peer[0] > 0) != (len(set(devs)) > 1):
            raise AssertionError(f"decode_batch devices={devs}: peer copies "
                                 f"{peer}")
        log(f"decode_batch {STREAM} devices={devs}: MD5 matches golden; "
            f"{shards} shards, launches {got} as predicted; peer copies "
            f"{peer[0]} ({peer[1] / 1e6:.3f} MB); H2D uploads "
            f"{sum(v for k, v in xfer.UPLOADS.items() if k != 'peer')}")
        xfer.reset()
        (_, _, csum, n), counts = run_path(
            f"{STREAM} decode_batch_device devices={devs}",
            lambda: DD.decode_batch_device(data, devices=devs),
            K1_K4 + ["mc_grid", "plane_checksum"])
        if csum != DD.cropped_checksum(outs) or n != len(items) or \
                xfer.D2H != 4 * holders or \
                counts["plane_checksum"] != holders:
            raise AssertionError(f"decode_batch_device devices={devs}: "
                                 f"checksum {csum}, {n} pictures, D2H "
                                 f"{xfer.D2H}, K7 {counts['plane_checksum']}")
        log(f"decode_batch_device {STREAM} devices={devs}: checksum {csum} "
            f"equals cropped_checksum; K7 {holders} launches, D2H "
            f"{xfer.D2H} bytes")
        del outs
    del items

    dps, _ = run_path(
        f"{INTRA} decode_intra_batch devices={two}",
        lambda: decode_intra_batch(read(INTRA), devices=two,
                                   check_sei_hash=True), K1_K4)
    got = hashlib.md5(b"".join(p.tobytes() for dp in dps
                               for p in dp.cropped())).hexdigest()
    statuses = [dp.hash_status for dp in dps]
    if got != gold[INTRA]["decoded_yuv_md5"] or \
            statuses != ["OK"] * gold[INTRA]["frames"]:
        raise AssertionError(f"decode_intra_batch devices={two}: MD5 {got}, "
                             f"hash SEIs {statuses}")
    log(f"decode_intra_batch {INTRA} devices={two}: MD5 matches golden, "
        "every hash SEI OK")
    del dps

    four = [f"cuda:{i % count}" for i in range(4)]
    names = MULTI + (DEC_APP,)
    outs, _ = run_path(
        f"decode_streams {' + '.join(names)} devices={four}",
        lambda: DD.decode_streams([read(nm) for nm in names], devices=four,
                                  check_sei_hash=True, threads=2),
        K1_K4 + ["mc_grid"])
    for nm, o in zip(names, outs):
        if len(o) != gold[nm]["frames"] or \
                outs_md5(o) != gold[nm]["decoded_yuv_md5"]:
            raise AssertionError(f"decode_streams devices={four}: {nm} MD5 "
                                 f"{outs_md5(o)}")
    log(f"decode_streams devices={four}: {len(names)} streams, each MD5 "
        "matches golden")
    del outs

    # references that cross devices for real: every level of two or more
    # pictures splits over the card and the host
    mixed = ["cuda:0", "cpu"]
    for name in ("tids4_ra_160x96", "randomaccess_416x240"):
        xfer.reset()
        outs, _ = run_path(f"{name} decode_batch devices={mixed}",
                           lambda: DD.decode_batch(read(name), devices=mixed),
                           ["residual_scatter", "loop_filter_level"])
        peer = (xfer.UPLOADS.get("peer", 0), xfer.BY_TAG.get("peer", 0))
        if outs_md5(outs) != gold[name]["decoded_yuv_md5"] or not peer[0]:
            raise AssertionError(f"decode_batch {name} devices={mixed}: MD5 "
                                 f"{outs_md5(outs)}, peer copies {peer}")
        log(f"decode_batch {name} devices={mixed}: MD5 matches golden; peer "
            f"copies {peer[0]} ({peer[1]} bytes)")
    if count > 1:
        log(f"dryrun_multidevice({count}): "
            f"{entry.dryrun_multidevice(count)} MD5s match golden")

    # fps with one device and with each list, in one call (host phases
    # vary between calls), one list after another and back
    order = [["cuda:0"]] + lists
    for devs in order + order[::-1]:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        outs = DD.decode_batch(data, devices=devs)
        secs = time.monotonic() - t0
        if outs_md5(outs) != md5:
            raise AssertionError(f"timed decode_batch devices={devs}: MD5")
        log(f"timed decode_batch {STREAM} devices={devs} ({card}): "
            f"{secs:.3f} s with the parse, {len(outs) / secs:.3f} fps")
        del outs


def check_exact(label, data, counts, per_picture=False):
    """K9 launches and `pcm` uploads (xfer, reset before the run) against
    the levels with a PCM block, and K1 launches with CCP rows against the
    (level, chroma component) pairs with a CCP TU, of a stream of EXACT
    (each picture its own level on the per-picture path); other streams
    need no PCM and no CCP launch counted beyond their modes."""
    from libhm_tpu_torch.hostdec.decoder import Decoder
    from libhm_tpu_torch.parallel.dag_decode import reference_levels
    from libhm_tpu_torch.utils import xfer
    if not any(label.startswith(name + " ") for name in EXACT):
        return
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(data)
    items = dec.collected
    levels = [[it] for it in items] if per_picture else \
        reference_levels(items)
    pcm = sum(any(it["pic"].pcm_list for it in lv) for lv in levels)
    ccp = sum(any(tu.comp == c and tu.cross_comp_alpha for it in lv
                  if it["sps"].chroma_format_idc == 3
                  for tu in it["pic"].tu_list)
              for lv in levels for c in (1, 2))
    got = (counts["pcm_level"], xfer.UPLOADS.get("pcm", 0),
           counts["residual_table_ccp"])
    if got != (pcm, pcm, ccp):
        raise AssertionError(f"{label}: K9 launches, pcm uploads, K1 "
                             f"launches with CCP rows {got}, expected "
                             f"{(pcm, pcm, ccp)}")
    log(f"{label}: {len(levels)} levels, {pcm} with PCM: K9 launches "
        f"{got[0]}, pcm uploads {got[1]}; {ccp} (level, chroma component) "
        f"pairs with CCP: K1 launches with CCP rows {got[2]}; H2D uploads by "
        f"tag {dict(xfer.UPLOADS)}")


def decode_md5(name, gold, check_sei_hash=False):
    import torch
    from libhm_tpu_torch.parallel.dag_decode import decode_batch
    data = open(os.path.join(ROOT, "testdata", gold[name]["bitstream"]),
                "rb").read()
    outs = decode_batch(data, device=torch.device("cuda"),
                        check_sei_hash=check_sei_hash)
    torch.cuda.synchronize()
    for pic in outs:
        for p in pic:
            if p.ndim != 2 or not p.size:
                raise AssertionError(f"{name}: bad output plane {p.shape}")
    if len(outs) != gold[name]["frames"]:
        raise AssertionError(f"{name}: {len(outs)} pictures, expected "
                             f"{gold[name]['frames']}")
    buf = b"".join(p.tobytes() for pic in outs for p in pic)
    got = hashlib.md5(buf).hexdigest()
    want = gold[name]["decoded_yuv_md5"]
    if got != want:
        raise AssertionError(f"{name}: MD5 {got} != golden {want}")
    return len(outs), outs


def timed_run(name, data, md5, card, check_sei_hash=False):
    """Parse, device recon and download of one stream, timed apart, with
    H2D/D2H bytes; returns the pictures' hash SEI statuses when checked."""
    import torch
    from libhm_tpu_torch.hostdec.decoder import Decoder
    from libhm_tpu_torch.parallel import dag_decode as DD
    from libhm_tpu_torch.utils import xfer
    xfer.reset()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    dec = Decoder(parse="native", recon="collect",
                  check_sei_hash=check_sei_hash)
    dec.decode_annexb(data)
    t1 = time.monotonic()
    pending = DD._recon_levels(dec.collected, [torch.device("cuda")])
    torch.cuda.synchronize()
    t2 = time.monotonic()
    outs = DD._materialize(dec, pending, check_sei_hash)
    t3 = time.monotonic()
    buf = b"".join(p.tobytes() for pic in outs for p in pic)
    if hashlib.md5(buf).hexdigest() != md5:
        raise AssertionError(f"timed run of {name}: MD5 mismatch")
    log(f"{name}: intra blocks per picture (decode order) "
        f"{[len(it['pic'].intra_list) for it in dec.collected]}")
    log(f"timed {name} ({card}): parse {t1 - t0:.3f} s, device recon "
        f"{t2 - t1:.3f} s (host prep + launches), download {t3 - t2:.3f} s, "
        f"{len(outs) / (t3 - t0):.2f} fps end to end; H2D "
        f"{xfer.H2D / len(outs) / 1e6:.3f} MB/picture, D2H "
        f"{xfer.D2H / len(outs) / 1e6:.3f} MB/picture; H2D by tag (MB) "
        f"{ {k: round(v / 1e6, 3) for k, v in sorted(xfer.BY_TAG.items())} }")
    return [dp.hash_status for dp, _, _ in pending]


# bit depths 13-16 (the hbd phase): the Main 4:4:4 16 Intra 1080p stream
# made by the repo's encoder, and its two 160x96 proxies (16-bit 4:4:4,
# 14-bit 4:2:0), all in testdata/port_streams.json
HBD = "rext444_16b_intra_1080p"
HBD_SMALL = ("rext444_16b_intra_160x96", "main14_intra_160x96")
# inter pictures above 12 bits: Monochrome 16 random access at 1080p and
# its 160x96 proxy, and 14-bit 4:2:0 random access whose first coded video
# sequence has explicit weighted prediction (K6) and whose second has none
# (K5)
HBD_RA = ("mono16_ra_1080p", "mono16_ra_160x96", "main14_ra_160x96")
HBD_WP = "main14_ra_160x96"
# extended precision (the extprec phase): HBD with the flag set
EXT = HBD + "_extprec"


def check_hbd(results, ra_levels, tool_levels, intra_items, hbd_items, card,
              rng, rt_us):
    """The hbd phase's kernel checks: every kernel of the decode against
    its plain version at 16 bits (K5 and K6 also at 14), exact, each
    error joining its kernel's line in `results`.  K1 (the RA stream's
    flat rows, DST and 4x4 transform skip among them, whose shift
    15 - bd - 2 is -3 here; the tool stream's scaled rows), K2 (the intra
    1080p picture's luma wavefront, samples around 2^15) and the
    loop-filter level kernel (a seeded 1080p 4:2:0 level) run on the same
    shapes as at 10 bits, timed beside them: the planes are int32 either
    way.  The 16-bit stream's own level goes through the loop filter with
    its maps (int16 chroma tc, band shift 11) at an SAO offset scale of 6;
    K9 writes 16-bit PCM samples (2^15 and more)."""
    import numpy as np
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from lf_cases import level_case
    errs = {}

    def join(name, r):
        errs[name] = max(errs.get(name, 0), r.err)
        return r
    k1 = join("residual_scatter",
              check_k1(ra_levels, card, rng, "residual_scatter", bd=16))
    k1s = join("residual_scatter_scaled",
               check_k1(tool_levels, card, rng, "residual_scatter_scaled",
                        bd=16))
    k2, _ = check_k2(intra_items, card, rng, rt_us, bd=16, comps=(0,),
                     res_bits=12, warm=False)
    join("intra_wavefront", k2)
    # the same seeded level at 10 and 16 bits, timed in turns
    lf = {10: Result(), 16: Result()}
    for bd in (10, 16, 16, 10):
        planes, maps, kw = level_case(np.random.default_rng(16), device=DEV,
                                      Hp=1088, Wp=1920, H=1080, W=1920,
                                      bd_l=bd, log2_ctb=6)
        if bd == 16:
            maps["sao_scale_l"].fill_(6)
            maps["sao_scale_c"].fill_(6)
        _lf_case(f"seeded 1080p 4:2:0 level, {bd} bits", planes, maps, kw,
                 card, lf[bd])
    join("loop_filter_level", lf[16])
    for it in hbd_items:
        it["pps"].sao_offset_scale_luma = 6
        it["pps"].sao_offset_scale_chroma = 6
    own = Result()
    _lf_case(f"{HBD} level ({len(hbd_items)} pictures, SAO offset scale 6)",
             *_lf_real(hbd_items, rng), card, own, time_it=False)
    join("loop_filter_level", own)
    for name, r in check_k3(card, rng, bd=16).items():
        join(name, r)
    join("sao_apply", check_k4(card, rng, bd=16))
    for bd in (14, 16):
        join("mc_grid", check_k5(card, rng, bd=bd))
        join("mc_weighted", check_k6(card, rng, bd=bd))
    join("mc_weighted", check_k6(card, rng, bd=16, wp=False))
    join("mc_weighted", check_k6(card, rng, bd=16, hpo=True))
    join("plane_checksum", check_k7(card, rng, bd=16))
    join("restore_unfiltered", check_k8(card, rng, bd=16))
    join("pcm_level", check_k9(card, rng, bd=16, shifts=(0, 2)))
    log(f"hbd: the same work at 16 and at 10 bits ({card}): K1 flat "
        f"{k1.ms:.4f} ms vs {results['residual_scatter'].ms:.4f} ms, K1 "
        f"scaled {k1s.ms:.4f} ms vs "
        f"{results['residual_scatter_scaled'].ms:.4f} ms (one table launch "
        f"per level and component, summed), K2 luma {k2.ms:.4f} ms vs "
        f"{results['intra_wavefront'].ms:.4f} ms, loop-filter level "
        f"{lf[16].ms / 2:.4f} ms vs {lf[10].ms / 2:.4f} ms (two runs each, in "
        f"turns; device times in the lines above)")
    log(f"hbd: max abs err at 14-16 bits {errs}")
    for name, e in errs.items():
        results[name].err = max(results[name].err, e)


def _with_statuses(fn):
    """(fn()'s result, the hash SEI statuses of the pictures its decode
    downloaded): dag_decode._materialize is watched for the run."""
    from libhm_tpu_torch.parallel import dag_decode as DD
    seen, orig = [], DD._materialize

    def spy(dec, pending, check_sei_hash):
        out = orig(dec, pending, check_sei_hash)
        seen.extend(dp.hash_status for dp, _, _ in pending)
        return out
    DD._materialize = spy
    try:
        return fn(), seen
    finally:
        DD._materialize = orig


def hbd_phase(ports, card):
    """Bit depths 13-16 end to end: the 16-bit 1080p intra stream and both
    intra proxies through decode_intra_batch, then those and the three
    random-access streams (HBD_RA) through decode_batch and HmDecoder (MD5
    of port_streams.json, every hash SEI OK) and decode_batch_device (its
    checksum against cropped_checksum of the decoded pictures), each path
    with the launch counters from 0: the random-access streams launch
    mc_grid on every path, and HBD_WP mc_weighted too; fps of each path."""
    import torch
    from libhm_tpu_torch.parallel import dag_decode as DD
    from libhm_tpu_torch.parallel.batch_decode import decode_intra_batch
    for name in (HBD,) + HBD_SMALL + HBD_RA:
        data = open(os.path.join(ROOT, "testdata", ports[name]["bitstream"]),
                    "rb").read()
        want, frames = ports[name]["decoded_yuv_md5"], ports[name]["frames"]
        ok = ["OK"] * frames
        needed = list(K1_K4)
        if name in HBD_RA:
            needed += ["mc_grid"] + (["mc_weighted"] if name == HBD_WP
                                     else [])
        fps, mc = {}, {}

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = fn()
            torch.cuda.synchronize()
            return out, time.monotonic() - t0
        if name not in HBD_RA:
            (dps, secs), _ = run_path(
                f"{name} decode_intra_batch",
                lambda: timed(lambda: decode_intra_batch(
                    data, check_sei_hash=True)), needed)
            md5 = hashlib.md5(b"".join(p.tobytes() for dp in dps
                                       for p in dp.cropped())).hexdigest()
            statuses = [dp.hash_status for dp in dps]
            if md5 != want or statuses != ok:
                raise AssertionError(f"{name} decode_intra_batch: MD5 {md5}"
                                     f", hash SEIs {statuses}")
            fps["decode_intra_batch"] = frames / secs
            del dps
        ((outs, statuses), secs), counts = run_path(
            f"{name} decode_batch",
            lambda: timed(lambda: _with_statuses(lambda: DD.decode_batch(
                data, device="cuda", check_sei_hash=True))), needed)
        if outs_md5(outs) != want or statuses != ok:
            raise AssertionError(f"{name} decode_batch: MD5 "
                                 f"{outs_md5(outs)}, hash SEIs {statuses}")
        fps["decode_batch"] = frames / secs
        mc["decode_batch"] = (counts["mc_grid"], counts["mc_weighted"])
        (_, pics, first, secs), counts = run_path(
            f"{name} HmDecoder", lambda: push_decode(data, sei_check=True),
            needed)
        statuses = [p.hash_status for p in pics]
        if pics_md5(pics) != want or statuses != ok:
            raise AssertionError(f"{name} HmDecoder: {len(pics)} pictures, "
                                 f"hash SEIs {statuses}")
        fps["HmDecoder"] = frames / secs
        mc["HmDecoder"] = (counts["mc_grid"], counts["mc_weighted"])
        ((_, _, csum, n), secs), counts = run_path(
            f"{name} decode_batch_device",
            lambda: timed(lambda: DD.decode_batch_device(data,
                                                         device="cuda")),
            needed + ["plane_checksum"])
        if csum != DD.cropped_checksum(outs) or n != frames:
            raise AssertionError(f"{name} decode_batch_device: checksum "
                                 f"{csum}, {n} pictures")
        fps["decode_batch_device"] = frames / secs
        mc["decode_batch_device"] = (counts["mc_grid"],
                                     counts["mc_weighted"])
        paths = "decode_batch and HmDecoder" if name in HBD_RA else \
            "decode_intra_batch, decode_batch and HmDecoder"
        log(f"hbd {name} ({ports[name]['bitdepth']} bits, "
            f"{ports[name]['chroma']}, {frames} pictures): MD5 {want} "
            f"matches port_streams.json and every hash SEI ({frames}) OK "
            f"through {paths}; decode_batch_device's checksum {csum} equals "
            f"cropped_checksum; (mc_grid, mc_weighted) launches by path "
            f"{mc}; fps with the parse ({card}): "
            f"{ {k: round(v, 3) for k, v in fps.items()} }, HmDecoder's "
            f"first picture after {first:.3f} s")
        del outs, pics


def check_ext(card, rng):
    """K1's wide form against its plain version, exact.  Seeded 1080p
    4:4:4 tables (tests/ext_cases.py) at 10, 12, 14 and 16 bits, levels
    over [-2^(bd+6), 2^(bd+6) - 1], every mode (DCT 4-32, DST, transform
    skip with rotation, bypass, RDPCM both ways, scaled rows with factors
    from 1): a luma table of F_EXT rows, and a chroma table with CCP rows
    (a seeded luma residual) and a quarter of its rows without F_EXT.
    Then the real level of EXT (both pictures, all three components):
    each component's wide table against its plain version, and timed
    beside the same component of HBD's level (the stream without the flag:
    K1's int16 form), in turns, with the plain version's time."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from ext_cases import ext_level
    from libhm_tpu_torch.hostdec.decoder import Decoder
    from libhm_tpu_torch.ops import transform as TK
    from libhm_tpu_torch.parallel import batch_decode as TB
    r = Result()
    shape = (1, 1088, 1920)
    seeded, n0 = {}, TK._K1_EXT.launches
    for bd in (10, 12, 14, 16):
        for chroma in (False, True):
            rows, coeffs, counts, flags, mats, _ = ext_level(
                rng, bd, *shape, chroma=chroma,
                plain_share=0.25 if chroma else 0.0)
            table = TB.upload_tables([(rows, coeffs, counts, flags)], DEV)[0]
            m = {n: torch.from_numpy(v).to(DEV) for n, v in mats.items()}
            res_l = torch.from_numpy(rng.integers(
                -(1 << (bd + 5)), 1 << (bd + 5), shape).astype(np.int32)) \
                .to(DEV) if chroma else None
            want = TK.residual_table_plain(
                torch.zeros(shape, dtype=torch.int32, device=DEV), table, m,
                res_l)
            got = TK.residual_table(
                torch.zeros(shape, dtype=torch.int32, device=DEV), table, m,
                res_l)
            torch.cuda.synchronize()
            e = max_abs_err(got, want)
            seeded[(bd, "ccp" if chroma else "luma")] = (
                len(rows), e, int((got != want).sum()),
                int(want.abs().max()))
            r.err = max(r.err, e)
    if TK._K1_EXT.launches != n0 + 8:
        raise AssertionError("K1's wide form: launches not counted")
    log(f"K1 wide form on seeded 1080p 4:4:4 tables ({card}): (bd, table) "
        f"-> (rows, max abs err, mismatches, largest |residual|) {seeded}")

    def level(name):
        dec = Decoder(parse="native", recon="collect")
        dec.decode_annexb(open(os.path.join(ROOT, "testdata",
                                            f"{name}.bin"), "rb").read())
        items = dec.collected
        tables, lists = TB.residual_tables(items)
        return items, tables, TB._MatrixTable(lists, DEV).tables
    items, ext_tables, mats = level(EXT)
    _, tables16, mats16 = level(HBD)
    sps = items[0]["sps"]
    shape = (len(items), sps.pic_height_ctbs << sps.log2_ctb,
             sps.pic_width_ctbs << sps.log2_ctb)
    ext_up = TB.upload_tables(ext_tables, DEV)
    up16 = TB.upload_tables(tables16, DEV)
    t = {"ext": [0.0, 0.0], "int16": [0.0, 0.0]}
    pms = 0.0
    for c, (te, t16) in enumerate(zip(ext_up, up16)):
        if not te.flags & TK.F_EXT or t16.flags & TK.F_EXT:
            raise AssertionError(f"{EXT} component {c}: flags {te.flags}, "
                                 f"{t16.flags} without the flag")
        got = torch.zeros(shape, dtype=torch.int32, device=DEV)
        want = torch.zeros(shape, dtype=torch.int32, device=DEV)
        TK.residual_table(got, te, mats)
        TK.residual_table_plain(want, te, mats)
        torch.cuda.synchronize()
        r.err = max(r.err, max_abs_err(got, want))
        runs = {"ext": lambda: TK.residual_table(got, te, mats),
                "int16": lambda: TK.residual_table(got, t16, mats16)}
        for k in ("ext", "int16", "int16", "ext"):
            t[k][0] += cuda_ms(runs[k], 20) / 2
            t[k][1] += device_ms(runs[k], 20) / 2
        pms += cuda_ms(lambda: TK.residual_table_plain(want, te, mats), 3)
        nbytes, ops = _k1_work(ext_tables[c][0], coef_bytes=4)
        r.add(0, 0.0, 0.0, nbytes, ops)
    r.ms, r.plain_ms = t["ext"][0], pms
    tb, by = r.bound()
    log(f"K1 wide form on {EXT}'s level ({len(items)} pictures, one table "
        f"per component, {sum(len(x[0]) for x in ext_tables)} TUs) "
        f"({card}): {t['ext'][0]:.4f} ms (device, queued behind a sleep: "
        f"{t['ext'][1]:.4f} ms) against the same level without the flag, "
        f"K1's int16 form, {t['int16'][0]:.4f} ms (device "
        f"{t['int16'][1]:.4f} ms), two runs each in turns; plain "
        f"{pms:.4f} ms; bound {tb:.6f} ms ({by}: {r.bytes} bytes, {r.ops} "
        f"operations); max abs err {r.err}")
    return r


def extprec_phase(ports, card):
    """Extended precision end to end: EXT through decode_intra_batch,
    decode_batch and HmDecoder (MD5 of port_streams.json; the stream's
    hash SEIs hash its decode without the flag, so they are not checked)
    and decode_batch_device (its checksum against cropped_checksum of the
    decoded pictures), each path with the launch counters from 0 and K1's
    wide form launched; fps of each.  Returns the wide form's launches on
    decode_batch."""
    import torch
    from libhm_tpu_torch.parallel import dag_decode as DD
    from libhm_tpu_torch.parallel.batch_decode import decode_intra_batch
    data = open(os.path.join(ROOT, "testdata", ports[EXT]["bitstream"]),
                "rb").read()
    want, frames = ports[EXT]["decoded_yuv_md5"], ports[EXT]["frames"]
    needed = K1_K4 + ["residual_table_ext"]
    fps = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        return out, time.monotonic() - t0
    (dps, secs), _ = run_path(f"{EXT} decode_intra_batch",
                              lambda: timed(lambda: decode_intra_batch(data)),
                              needed)
    md5 = hashlib.md5(b"".join(p.tobytes() for dp in dps
                               for p in dp.cropped())).hexdigest()
    if md5 != want:
        raise AssertionError(f"{EXT} decode_intra_batch: MD5 {md5}")
    fps["decode_intra_batch"] = frames / secs
    del dps
    (outs, secs), counts = run_path(
        f"{EXT} decode_batch",
        lambda: timed(lambda: DD.decode_batch(data, device="cuda")), needed)
    if outs_md5(outs) != want:
        raise AssertionError(f"{EXT} decode_batch: MD5 {outs_md5(outs)}")
    fps["decode_batch"] = frames / secs
    launches = counts["residual_table_ext"]
    (_, pics, first, secs), _ = run_path(f"{EXT} HmDecoder",
                                         lambda: push_decode(data), needed)
    if pics_md5(pics) != want or len(pics) != frames:
        raise AssertionError(f"{EXT} HmDecoder: {len(pics)} pictures, MD5 "
                             f"{pics_md5(pics)}")
    fps["HmDecoder"] = frames / secs
    ((_, _, csum, n), secs), _ = run_path(
        f"{EXT} decode_batch_device",
        lambda: timed(lambda: DD.decode_batch_device(data, device="cuda")),
        needed + ["plane_checksum"])
    if csum != DD.cropped_checksum(outs) or n != frames:
        raise AssertionError(f"{EXT} decode_batch_device: checksum {csum}, "
                             f"{n} pictures")
    fps["decode_batch_device"] = frames / secs
    log(f"extprec {EXT}: MD5 matches port_streams.json through "
        f"decode_intra_batch, decode_batch and HmDecoder; "
        f"decode_batch_device's checksum {csum} equals cropped_checksum; "
        f"K1's wide form {launches} launches on decode_batch; fps with the "
        f"parse ({card}): { {k: round(v, 3) for k, v in fps.items()} }, "
        f"HmDecoder's first picture after {first:.3f} s")
    return launches


# the bench phase's device section: seconds it may take, one timed run
# each and decode_streams at 2 (bench_torch.py run alone takes medians of
# 3 and 4 streams too)
BENCH_BUDGET = 420
BENCH_KEYS = ("device_compute_fps", "cuda_fps", "h2d_mb_per_frame",
              "d2h_mb_per_frame")


def bench_phase(data, card):
    """The benchmark harness on the card: bench_torch.py's device section
    in a child process (as bench_torch.py runs it, with one timed run and
    two streams) on the RA 1080p stream, then tools/bench_kernels_torch.py's
    K1 and K6 rows.  Every line is logged with the card; fails unless the
    child exits 0 with device_compute_fps and device_checksum_ok true (the
    checksum against cropped_checksum of the native CPU decode), cuda_fps
    (each repetition's MD5 golden), multistream_fps at 2 and the bytes per
    picture, and unless every kernel row has max_abs_err 0 and a share of
    its bound of at most 1."""
    import importlib.util
    import bench_torch as BT
    from libhm_tpu_torch.hostdec.decoder import Decoder
    from libhm_tpu_torch.parallel.dag_decode import cropped_checksum
    t0 = time.monotonic()
    csum = cropped_checksum(Decoder(parse="native",
                                    recon="native").decode_annexb(data))
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench_torch.py"),
         "--device-child", "--budget", str(BENCH_BUDGET), "--expect-csum",
         str(csum), "--runs", "1", "--streams", "2"], cwd=ROOT,
        capture_output=True, text=True, timeout=BENCH_BUDGET + 120)
    for ln in r.stdout.splitlines():
        log(f"bench_torch.py --device-child ({card}): {ln}")
    got = BT.merge_lines(r.stdout)
    missing = [k for k in BENCH_KEYS if k not in got]
    if r.returncode != 0 or missing or \
            got.get("device_checksum_ok") is not True or \
            "2" not in got.get("multistream_fps", {}):
        raise AssertionError(f"bench_torch.py device section: exit "
                             f"{r.returncode}, missing {missing}, lines "
                             f"{got}\n{r.stderr[-3000:]}")
    log(f"bench_torch.py device section: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    spec = importlib.util.spec_from_file_location(      # tools/: no package
        "bench_kernels_torch", os.path.join(ROOT, "tools",
                                            "bench_kernels_torch.py"))
    BK = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(BK)
    log(BK.header("cuda"))
    rows = BK.measure("cuda")
    for row in rows:
        log(f"bench_kernels_torch ({card}): {json.dumps(row)}")
    bad = [row for row in rows if row["max_abs_err"] != 0 or
           row["share"] is None or row["share"] > 1]
    if bad:
        raise AssertionError(f"bench_kernels_torch rows off: {bad}")
    log(f"tools/bench_kernels_torch.py: {len(rows)} rows in "
        f"{time.monotonic() - t0:.1f} s")


# ---------------------------------------------------------------------------
# the encoder phase
ENC16 = "rext444_16b_intra_160x96"   # re-encoded on the card from its recipe
ENC_PICS = 2                      # pictures of STREAM that the encode takes
C3 = "mixed_qp16"                 # tests/enc_cases.py C3_CASES


class EncoderCapture:
    """While installed: every launch an encode makes of the loop-filter
    kernel (its inputs and a copy of its output) and of K8 (a copy of its
    planes before the restore), the host planes before and after each
    picture's in-loop filter, and the wall seconds of the encoder's phases
    ("filter": PictureFilter's uploads, maps, launches and downloads); the
    port's numpy loop filter (hostdec/loopfilter_np) raises, so the encode
    cannot reach it."""

    PHASES = ("_native_compress", "_estimate_sao", "_emit_slices")

    def __init__(self):
        from libhm_tpu_torch.encoder import encoder as EN
        from libhm_tpu_torch.hostdec import loopfilter_np as NP
        from libhm_tpu_torch.ops import loopfilter as LF
        from libhm_tpu_torch.ops import pcm as PK
        from libhm_tpu_torch.parallel.device_filters import PictureFilter
        self.lf, self.k8, self.pictures = [], [], []
        self.secs = dict.fromkeys(self.PHASES + ("filter",), 0.0)
        lf, k8, pictures, secs = self.lf, self.k8, self.pictures, self.secs

        def lf_spy(planes, maps, **kw):
            out = real_lf(planes, maps, **kw)
            # (a copy: K8 restores the last launch's output in place)
            lf.append((planes, maps, kw, [o.clone() for o in out]))
            return out

        def k8_spy(planes, pre, rmask, **kw):
            before = planes.clone()
            out = real_k8(planes, pre, rmask, **kw)
            k8.append((before, pre, rmask, kw, out.clone()))
            return out

        def filter_spy(enc, poc, *a, **k):
            pre = [p.copy() for p in enc.recon]
            real_filter(enc, poc, *a, **k)
            pictures.append((pre, [p.copy() for p in enc.recon], enc.pic,
                             enc.sps, enc.pps))

        def timed(name, fn):
            def run(*a, **k):
                t0 = time.monotonic()
                try:
                    return fn(*a, **k)
                finally:
                    secs[name] += time.monotonic() - t0
            return run

        def refused(*a, **k):
            raise AssertionError("the encoder ran hostdec/loopfilter_np")
        real_lf, real_k8 = LF.loop_filter_level, PK.restore_unfiltered
        real_filter = EN.IntraEncoder._loop_filter
        self._undo = [(LF, "loop_filter_level", real_lf),
                      (PK, "restore_unfiltered", real_k8),
                      (EN.IntraEncoder, "_loop_filter", real_filter),
                      (NP, "deblock_picture", NP.deblock_picture),
                      (NP, "sao_picture", NP.sao_picture)]
        self._undo += [(EN.IntraEncoder, n, getattr(EN.IntraEncoder, n))
                       for n in self.PHASES]
        self._undo += [(PictureFilter, n, getattr(PictureFilter, n))
                       for n in ("__init__", "run", "restore")]
        LF.loop_filter_level, PK.restore_unfiltered = lf_spy, k8_spy
        EN.IntraEncoder._loop_filter = filter_spy
        NP.deblock_picture = NP.sao_picture = refused
        for n in self.PHASES:
            setattr(EN.IntraEncoder, n, timed(n, getattr(EN.IntraEncoder, n)))
        for n in ("__init__", "run", "restore"):
            setattr(PictureFilter, n, timed("filter",
                                            getattr(PictureFilter, n)))

    def remove(self):
        for owner, name, fn in self._undo:
            setattr(owner, name, fn)

    def check(self, label, card):
        """Each captured launch against the plain version on CPU copies of
        its inputs: raises on a mismatch; returns (loop-filter Result,
        K8 Result)."""
        import torch
        from libhm_tpu_torch.ops import loopfilter as LF
        from libhm_tpu_torch.ops import pcm as PK
        torch.cuda.synchronize()
        r_lf, r_k8 = Result(), Result()
        for planes, maps, kw, out in self.lf:
            want = LF.loop_filter_level_plain(
                [p.cpu() for p in planes],
                {k: v.cpu() for k, v in maps.items()}, **kw)
            r_lf.err = max([r_lf.err] + [max_abs_err(o.cpu(), w)
                                         for o, w in zip(out, want)])
        for before, pre, rmask, kw, out in self.k8:
            want = PK.restore_unfiltered_plain(before.cpu(), pre.cpu(),
                                               rmask.cpu(), **kw)
            r_k8.err = max(r_k8.err, max_abs_err(out.cpu(), want))
        log(f"{label}: {len(self.lf)} loop_filter_level launches (masks "
            f"{[kw['mask'] for _, _, kw, *_ in self.lf]}), {len(self.k8)} "
            f"K8 launches, each against its plain version on CPU copies of "
            f"its inputs: max_abs_err {r_lf.err} / {r_k8.err} ({card})")
        if r_lf.err or r_k8.err:
            raise AssertionError(f"{label}: the encoder's launches differ "
                                 "from their plain versions")
        return r_lf, r_k8

    def time_first(self, r_lf=None, r_k8=None):
        """Add to the kernels line's rows: the first picture's launches
        (its deblocking and SAO launches; its three K8 launches), timed on
        their own inputs (20 kernel runs, 2 plain runs on the card, CUDA
        events), with their bytes and operations."""
        from libhm_tpu_torch.ops import loopfilter as LF
        from libhm_tpu_torch.ops import pcm as PK
        for planes, maps, kw, _ in self.lf[:2] if r_lf else ():
            ms = cuda_ms(lambda: LF.loop_filter_level(planes, maps, **kw), 20)
            pms = cuda_ms(lambda: LF.loop_filter_level_plain(planes, maps,
                                                            **kw), 2)
            r_lf.add(0, ms, pms, *_lf_work(planes, maps, kw))
        for before, pre, rmask, kw, _ in self.k8[:3] if r_k8 else ():
            scratch = before.clone()
            ms = cuda_ms(lambda: PK.restore_unfiltered(scratch, pre, rmask,
                                                       **kw), 20)
            pms = cuda_ms(lambda: PK.restore_unfiltered_plain(
                scratch, pre, rmask, **kw), 2)
            r_k8.add(0, ms, pms, 3 * before.nbytes + rmask.nbytes,
                     before.numel())


def _encode(cfg, pics, device):
    """(stream, encoder, wall seconds) of IntraEncoder(cfg, device)."""
    import torch
    from libhm_tpu_torch.encoder.encoder import IntraEncoder
    torch.cuda.synchronize()
    t0 = time.monotonic()
    enc = IntraEncoder(cfg, device=device)
    stream = enc.encode_stream(pics)
    torch.cuda.synchronize()
    return stream, enc, time.monotonic() - t0


def encoder_phase(gold, card):
    """The port's encoder with its in-loop filter on the card (the
    loop-filter kernel, K8 where PCM is restored):
    - the 16-bit 4:4:4 160x96 stream re-encoded from its cfg's recipe
      through enc_app (--device cuda): the bytes of the committed stream;
    - the Monochrome 16 random-access recipe of RA16 through IntraEncoder
      on the card, its motion search in the native search's int32 form
      (ROADMAP C14; the int16 form never called): the MD5 of the Python
      search's bytes, decode_batch on the card with every hash SEI OK and
      to the encoder's reconstructions;
    - a picture coded partly as PCM with pcm_loop_filter_disabled (K8 on
      the encoder's path): the bytes that the encode on the CPU writes;
    - two pictures of STREAM (1920x1080 Main10, decoded by the port's
      native recon) encoded lowdelayP with SAO: the stream decoded by
      decode_batch on the card with every hash SEI OK and to the encoder's
      reconstructions, each picture's in-loop filter equal to the port's
      numpy one on the same inputs (both timed), fps and the host split;
    each with the launch counters from 0 and every loop-filter and K8
    launch held against its plain version.  Returns the kernels line's
    rows (Results) and launches."""
    import numpy as np
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from enc_cases import (C3_CASES, RA16, RA16_MD5, c3_config,
                           noise_picture, pcm_frames, recipe_input,
                           recipe_source)
    from libhm_tpu_torch.apps import enc_app
    from libhm_tpu_torch.encoder import encoder as EN
    from libhm_tpu_torch.encoder.encoder import EncoderConfig
    from libhm_tpu_torch.hostdec import loopfilter_np as NP
    from libhm_tpu_torch.hostdec.decoder import Decoder
    from libhm_tpu_torch.hostdec.native_bridge import try_load
    from libhm_tpu_torch.kernels import build as KB
    from libhm_tpu_torch.parallel import dag_decode as DD
    from libhm_tpu_torch.utils import xfer
    t_phase = time.monotonic()

    # the 16-bit stream from its recipe, through the CLI
    cfg_path = os.path.join("testdata", f"{ENC16}.cfg")
    src, n16 = recipe_source(os.path.join(ROOT, cfg_path))
    with tempfile.TemporaryDirectory(dir=KB.BUILD) as tmp:
        yuv, out = os.path.join(tmp, "src.yuv"), os.path.join(tmp, "out.bin")
        open(yuv, "wb").write(src)
        cap = EncoderCapture()
        try:
            rc, counts = run_path(
                f"{ENC16} enc_app --device cuda",
                lambda: enc_app.main(["-c", cfg_path, "-i", yuv, "-b", out,
                                      "--device", DEV]),
                ["loop_filter_level"])
        finally:
            cap.remove()
        stream = open(out, "rb").read()
    want = open(os.path.join(ROOT, "testdata", f"{ENC16}.bin"), "rb").read()
    if rc != 0 or stream != want or counts["loop_filter_level"] != 2 * n16:
        raise AssertionError(f"{ENC16} on the card: exit {rc}, "
                             f"{len(stream)} bytes (want {len(want)}, "
                             f"equal {stream == want}), launches {counts}")
    cap.check(f"{ENC16} enc_app", card)
    log(f"{ENC16} re-encoded on the card from its recipe: {len(stream)} "
        f"bytes, equal to testdata/{ENC16}.bin; loop-filter launches "
        f"{counts['loop_filter_level']} (deblocking and SAO of {n16} "
        "pictures)")

    # ROADMAP C14: the 16-bit random-access recipe, its motion search in
    # the native search's int32 form, its in-loop filter on the card
    cfg16, pics = recipe_input(os.path.join(ROOT, "testdata", f"{RA16}.cfg"))
    lib = try_load()             # the encoder's (one library a process)
    if lib is None:
        raise AssertionError(f"{RA16}: the native search did not load")
    calls = dict.fromkeys(("enc_me_search", "enc_bi_refine",
                           "enc_me_search32", "enc_bi_refine32"), 0)

    def call_counter(name, fn):
        def run(*a):
            calls[name] += 1
            return fn(*a)
        return run
    real_search = {nm: getattr(lib, nm) for nm in calls}
    for nm, fn in real_search.items():
        setattr(lib, nm, call_counter(nm, fn))
    cap = EncoderCapture()
    try:
        (stream, enc, secs), counts = run_path(
            f"{RA16} encode", lambda: _encode(cfg16, pics, DEV),
            ["loop_filter_level"])
    finally:
        cap.remove()
        for nm, fn in real_search.items():
            setattr(lib, nm, fn)
    md5 = hashlib.md5(stream).hexdigest()
    if md5 != RA16_MD5 or counts["loop_filter_level"] != 2 * len(pics) or \
            not calls["enc_me_search32"] or not calls["enc_bi_refine32"] or \
            calls["enc_me_search"] or calls["enc_bi_refine"]:
        raise AssertionError(f"{RA16} on the card: {len(stream)} bytes, MD5 "
                             f"{md5} (want {RA16_MD5}), launches {counts}, "
                             f"native search calls {calls}")
    cap.check(f"{RA16} encode", card)
    (outs, statuses), _ = run_path(
        f"{RA16} encoded, decode_batch",
        lambda: _with_statuses(lambda: DD.decode_batch(
            stream, device=DEV, check_sei_hash=True)),
        K1_K4 + ["mc_grid"])
    recon = {s[2]: s[3] for s in enc.stats}
    same = len(outs) == len(pics) and all(
        np.array_equal(np.asarray(a), b) for poc, pic in enumerate(outs)
        for a, b in zip(pic, recon[poc]))
    if statuses != ["OK"] * len(pics) or not same:
        raise AssertionError(f"{RA16} encoded, decoded on the card: hash "
                             f"SEIs {statuses}, equal to the "
                             f"reconstructions {same}")
    log(f"{RA16} (Monochrome 16, random access, {len(pics)} pictures) "
        f"encoded from its recipe by IntraEncoder(cfg, device={DEV!r}) in "
        f"{secs:.3f} s wall: {len(stream)} bytes, "
        f"{8 * len(stream) * cfg16.fps / len(pics) / 1000:.4f} kbps, MD5 "
        f"{md5}, equal to the Python search's (tests/enc_cases.py "
        f"RA16_MD5); native search calls {calls}; loop-filter launches "
        f"{counts['loop_filter_level']}; decode_batch on the card: every "
        f"hash SEI ({len(pics)}) OK, pictures equal to the encoder's "
        f"reconstructions ({card})")

    # PCM with pcm_loop_filter_disabled: the restore (K8)
    pics = pcm_frames(128, 64)

    def pcm_cfg():
        cfg = EncoderConfig(128, 64, qp=16)
        cfg.pcm_enabled = cfg.pcm_filter_disabled = True
        return cfg
    cap = EncoderCapture()
    try:
        (stream, enc, _), counts = run_path(
            "PCM picture encode", lambda: _encode(pcm_cfg(), pics, DEV),
            ["loop_filter_level", "restore_unfiltered"])
    finally:
        cap.remove()
    want = _encode(pcm_cfg(), pics, "cpu")[0]
    if stream != want or counts["loop_filter_level"] != 2 or \
            counts["restore_unfiltered"] != 3:
        raise AssertionError(f"PCM encode on the card: equal to the CPU's "
                             f"{stream == want}, launches {counts}")
    _, pcm_k8 = cap.check("PCM picture encode", card)
    cap.time_first(r_k8=pcm_k8)
    k8_launches = counts["restore_unfiltered"]
    log(f"PCM picture (128x64, QP 16, {int(np.asarray(enc.pic.pcm).sum())} "
        f"PCM 4x4 units) encoded on the card: {len(stream)} bytes, equal to "
        f"the CPU encode; loop filter 2 launches, K8 {k8_launches}")

    # the picture of ROADMAP C3, on which a rejected PCM trial of the RDO
    # quadtree left its pcm marks for K8 (the encoder rolls them back)
    kind, seed, qp = C3_CASES[C3]
    pics = noise_picture(128, 64, kind, seed)
    cap = EncoderCapture()
    try:
        (stream, enc, _), counts = run_path(
            f"C3 picture ({C3}) encode",
            lambda: _encode(c3_config(EN, qp), pics, DEV),
            ["loop_filter_level", "restore_unfiltered"])
    finally:
        cap.remove()
    want = _encode(c3_config(EN, qp), pics, "cpu")[0]
    if stream != want or counts["loop_filter_level"] != 2 or \
            counts["restore_unfiltered"] != 3:
        raise AssertionError(f"C3 picture on the card: equal to the CPU's "
                             f"encode {stream == want}, launches {counts}")
    restored = sum(int((out != before).sum())
                   for before, _, _, _, out in cap.k8)
    _, r_c3 = cap.check(f"C3 picture ({C3}) encode", card)
    marked = float(np.asarray(enc.pic.pcm).astype(bool).mean())
    (outs, statuses), _ = run_path(
        f"C3 picture ({C3}) decode_batch",
        lambda: _with_statuses(lambda: DD.decode_batch(
            stream, device=DEV, check_sei_hash=True)),
        K1_K4 + ["pcm_level", "restore_unfiltered"])
    same = len(outs) == 1 and all(np.array_equal(np.asarray(a), b)
                                  for a, b in zip(outs[0], enc.stats[0][3]))
    if statuses != ["OK"] or not same:
        raise AssertionError(f"C3 picture decoded on the card: hash SEIs "
                             f"{statuses}, equal to the reconstruction "
                             f"{same}")
    log(f"C3 picture ({C3}: 128x64 {kind} noise, seed {seed}, QP {qp}, "
        f"pcm_loop_filter_disabled) encoded on the card: {len(stream)} "
        f"bytes, equal to the CPU encode; K8 {counts['restore_unfiltered']} "
        f"launches, max_abs_err {r_c3.err} against the plain version; PCM "
        f"marks on {marked:.2%} of the picture, {restored} samples restored "
        f"({restored / (128 * 64 * 3 // 2):.2%} of the picture's "
        f"{128 * 64 * 3 // 2}); decode_batch on the card: hash SEI "
        f"{statuses[0]}, picture equal to the encoder's reconstruction")

    # full width: two pictures of STREAM, lowdelayP, SAO on
    data = open(os.path.join(ROOT, "testdata", gold[STREAM]["bitstream"]),
                "rb").read()
    src = Decoder(parse="native", recon="native").decode_annexb(data)
    pics = [tuple(np.asarray(p).astype(np.uint16) for p in pic)
            for pic in src[:ENC_PICS]]
    H, W = pics[0][0].shape
    cfg = EncoderConfig(W, H, qp=32, bit_depth=10, gop="lowdelayP")
    cap = EncoderCapture()
    xfer.reset()
    try:
        ((stream, enc, secs), dev), counts = run_path(
            f"{STREAM} {ENC_PICS} pictures encode",
            lambda: device_events(lambda: _encode(cfg, pics, DEV)),
            ["loop_filter_level"])
    finally:
        cap.remove()
    up, down = dict(xfer.BY_TAG), xfer.D2H
    if counts["loop_filter_level"] != 2 * ENC_PICS:
        raise AssertionError(f"1080p encode: launches {counts}")
    r_lf, _ = cap.check(f"{STREAM} encode", card)
    (lf_ms, lf_n), (h2d_ms, h2d_n), (d2h_ms, d2h_n) = (
        dev_sum(dev, k) for k in ("loop_filter_kernel", "HtoD", "DtoH"))
    cap.time_first(r_lf=r_lf)
    np_secs = 0.0
    for pre, post, pic, sps, pps in cap.pictures:
        planes = [p.copy() for p in pre]
        t0 = time.monotonic()
        NP.deblock_picture(planes, pic, sps, pps)
        NP.sao_picture(planes, pic, sps, pps)
        np_secs += time.monotonic() - t0
        for c, (a, b) in enumerate(zip(planes, post)):
            s = (sps.chroma_shift_x(), sps.chroma_shift_y()) if c else (0, 0)
            if not np.array_equal(a[:H >> s[1], :W >> s[0]],
                                  b[:H >> s[1], :W >> s[0]]):
                raise AssertionError("1080p encode: the card's in-loop "
                                     "filter differs from loopfilter_np")
    (outs, statuses), _ = run_path(
        f"{STREAM} encoded, decode_batch",
        lambda: _with_statuses(lambda: DD.decode_batch(
            stream, device=DEV, check_sei_hash=True)), K1_K4)
    recon = {s[2]: s[3] for s in enc.stats}
    same = len(outs) == ENC_PICS and all(
        np.array_equal(np.asarray(a), b) for poc, pic in enumerate(outs)
        for a, b in zip(pic, recon[poc]))
    if statuses != ["OK"] * ENC_PICS or not same:
        raise AssertionError(f"1080p encode decoded on the card: hash SEIs "
                             f"{statuses}, equal to the reconstructions "
                             f"{same}")
    split = ", ".join(f"{k} {v:.3f} s" for k, v in cap.secs.items())
    log(f"{STREAM}: {ENC_PICS} pictures ({W}x{H} Main10 4:2:0) encoded "
        f"lowdelayP QP 32 with SAO on the card in {secs:.3f} s "
        f"({ENC_PICS / secs:.4f} fps), {len(stream)} bytes; decoded by "
        f"decode_batch on the card, every hash SEI OK, pictures equal to "
        f"the encoder's reconstructions ({card})")
    log(f"encoder host split (wall seconds of each method over the encode, "
        f"timed by wrapping it; 'filter' is PictureFilter: maps, uploads, "
        f"launches, downloads): {split}")
    log(f"encoder in-loop filter on the card (device-side events of the "
        f"encode under torch.profiler): {counts['loop_filter_level']} "
        f"launches, {lf_ms:.4f} ms device ({lf_n} kernels seen); H2D "
        f"{up} bytes by tag, {h2d_n} memcpys, {h2d_ms:.3f} ms device; D2H "
        f"{down} bytes, {d2h_n} memcpys, {d2h_ms:.3f} ms device; "
        f"PictureFilter {cap.secs['filter']:.3f} s on the host; the port's "
        f"loopfilter_np on the same {ENC_PICS} pictures on the host "
        f"(deblock_picture + sao_picture, equal output) {np_secs:.3f} s "
        f"({card})")
    log(f"encoder phase: {time.monotonic() - t_phase:.1f} s")
    return {"enc_lf": (r_lf, counts["loop_filter_level"]),
            "enc_k8": (pcm_k8, k8_launches)}


HOST_LOG = ("POC    0 TId: 0 ( I-SLICE, nQP 32 QP 32 ) 100000 bits\n"
            "POC    1 TId: 0 ( P-SLICE, nQP 33 QP 33 ) 4000 bits\n"
            "POC    2 TId: 0 ( P-SLICE, nQP 34 QP 34 ) 2000 bits\n"
            "POC    3 TId: 0 ( P-SLICE, nQP 33 QP 33 ) 6000 bits\n")


def pcm_flush_phase(card):
    """ROADMAP C13 on the card: pcm_frames(128, 64) encoded intra at QP 8
    with PCM (no pcm_loop_filter_disabled) by IntraEncoder on the card,
    the bit offset within its byte at which the flush after each PCM CU's
    pcm_flag ended recorded (CabacEncoder.pcm_payload watched), one of
    them 0 (no pcm_alignment_zero_bit); its bytes equal to the CPU
    encode's; decode_batch on the card with the hash SEI check: OK, the
    encoder's reconstruction, K9 and the loop-filter kernel launched."""
    import numpy as np
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from enc_cases import pcm_frames
    from libhm_tpu_torch.encoder import cabac_enc as CE
    from libhm_tpu_torch.encoder.encoder import EncoderConfig
    from libhm_tpu_torch.parallel import dag_decode as DD
    offsets, real = [], CE.CabacEncoder.pcm_payload

    def spy(self, bits):
        offsets.append(self.bw.nbits)
        return real(self, bits)

    def cfg():
        c = EncoderConfig(128, 64, gop="intra", qp=8)
        c.pcm_enabled = True
        c.log2_min_ipcm, c.log2_max_ipcm = 3, 5
        return c
    pics = pcm_frames(128, 64)
    CE.CabacEncoder.pcm_payload = spy
    try:
        (stream, enc, secs), _ = run_path(
            "C13 PCM picture encode", lambda: _encode(cfg(), pics, DEV),
            ["loop_filter_level"])
    finally:
        CE.CabacEncoder.pcm_payload = real
    if 0 not in offsets or stream != _encode(cfg(), pics, "cpu")[0]:
        raise AssertionError(f"C13 picture: flush offsets {offsets}, equal "
                             "to the CPU encode "
                             f"{stream == _encode(cfg(), pics, 'cpu')[0]}")
    (outs, statuses), counts = run_path(
        "C13 PCM picture decode_batch",
        lambda: _with_statuses(lambda: DD.decode_batch(
            stream, device=DEV, check_sei_hash=True)),
        ["pcm_level", "loop_filter_level", "intra_wavefront"])
    same = len(outs) == 1 and all(
        np.array_equal(np.asarray(a), b)
        for a, b in zip(outs[0], enc.stats[0][3]))
    if statuses != ["OK"] or not same:
        raise AssertionError(f"C13 picture on the card: hash SEIs "
                             f"{statuses}, the encoder's reconstruction "
                             f"{same}")
    log(f"C13: PCM picture (128x64, QP 8) encoded on the card in "
        f"{secs:.3f} s, {len(stream)} bytes equal to the CPU encode, flush "
        f"offsets after its {len(offsets)} pcm_flags {offsets}; "
        f"decode_batch on the card: hash SEI {statuses[0]}, the encoder's "
        f"reconstruction; launches K9 {counts['pcm_level']}, loop filter "
        f"{counts['loop_filter_level']}, K2 {counts['intra_wavefront']}, K1 "
        f"{counts['residual_scatter']} ({card})")


def host_phase(gold, ports):
    """The port's host-only modules on the card's host, where JAX need not
    be installed, each checked: annexb_bytecount's rows of a golden (SPS
    and PPS among them, the bytes short of the stream by its start codes
    only); collect_bits of the same golden summing to its bits exactly;
    convert_bitdepth 8 -> 10 -> 8 on seeded samples back to the input;
    bitrate_targeting extract on an encoder log fed on its stdin; and the
    libHMDec C ABI (libhmdec.so, built alongside the kernels) pushing the
    10-bit RA golden to its MD5 with its own MD5 SEI check passing, and
    the 16-bit streams mono16_ra_160x96 (Monochrome 16 random access) and
    rext444_16b_intra_160x96 and the two-sequence main14_ra_160x96 to their
    MD5s in port_streams.json (the short* planes read back as uint16),
    each with its MD5 SEI check passing."""
    import contextlib
    import io
    import numpy as np
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import libhmdec_abi as ABI
    from libhm_tpu_torch.apps import annexb_bytecount, convert_bitdepth
    from libhm_tpu_torch.hostdec import nal as N
    from libhm_tpu_torch.hostdec import stats
    from libhm_tpu_torch.kernels import build as KB
    t_phase = time.monotonic()
    name = "tids4_ra_160x96"
    path = os.path.join(ROOT, "testdata", gold[name]["bitstream"])
    data = open(path, "rb").read()

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = annexb_bytecount.main([path])
    rows = out.getvalue().splitlines()
    nbytes = sum(int(r.split()[-1]) for r in rows)
    starts = len(data) - sum(len(e) for e in N.split_annexb(data))
    if rc or not any(" SPS " in r for r in rows) or \
            not any(" PPS " in r for r in rows) or nbytes + starts != \
            len(data):
        raise AssertionError(f"annexb_bytecount {name}: exit {rc}, rows "
                             f"{rows}")
    log(f"host: annexb_bytecount {name}: {len(rows)} NAL unit types, "
        f"{nbytes} bytes + {starts} start-code bytes = {len(data)}")
    for r in rows:
        log("  " + r)

    t = stats.collect_bits(data, per_component=True, per_tu_size=True)
    total, n_eng = t.pop("__total__"), t.pop("__n_engines__")
    if total != len(data) * 8 or sum(t.values()) != total:
        raise AssertionError(f"collect_bits {name}: total {total}, sum "
                             f"{sum(t.values())}, stream {len(data) * 8}")
    top = sorted(t.items(), key=lambda kv: -kv[1])[:3]
    log(f"host: collect_bits {name}: {len(t)} categories over {n_eng} "
        f"CABAC engines sum to {total} bits, the stream's bytes x 8; "
        f"largest {', '.join(f'{k} {v:.0f}' for k, v in top)}")

    rng = np.random.default_rng(16)
    x = rng.integers(0, 256, 3 * 416 * 240 // 2).astype(np.uint8)
    with tempfile.TemporaryDirectory(dir=KB.BUILD) as tmp:
        src, up, back = (os.path.join(tmp, f) for f in ("8.yuv", "10.yuv",
                                                         "back.yuv"))
        x.tofile(src)
        rcs = [convert_bitdepth.main(["-i", a, "-o", b, "--in-depth", d_in,
                                      "--out-depth", d_out])
               for a, b, d_in, d_out in ((src, up, "8", "10"),
                                         (up, back, "10", "8"))]
        ten, eight = np.fromfile(up, np.uint16), np.fromfile(back, np.uint8)
    if rcs != [0, 0] or not np.array_equal(ten, x.astype(np.uint16) << 2) \
            or not np.array_equal(eight, x):
        raise AssertionError(f"convert_bitdepth round trip: exits {rcs}")
    log(f"host: convert_bitdepth {x.size} seeded 8-bit samples to 10 bits "
        f"(each x 4) and back, equal to the input")

    r = subprocess.run([sys.executable, "-m",
                        "libhm_tpu_torch.apps.bitrate_targeting", "extract"],
                       input=HOST_LOG, capture_output=True, text=True,
                       cwd=ROOT, timeout=60)
    if r.returncode or r.stdout.split() != ["5000", "2000"]:
        raise AssertionError(f"bitrate_targeting extract: exit "
                             f"{r.returncode}, {r.stdout!r} {r.stderr!r}")
    log(f"host: bitrate_targeting extract on a 4-picture log on its stdin: "
        f"{r.stdout.strip()} bits per temporal layer (the I picture left "
        f"out)")

    ra = "randomaccess_main10_416x240"
    lib = ABI.load(os.path.join(ABI.NATIVE, "libhmdec.so"))
    pics, hash_ok = ABI.decode(lib, open(os.path.join(
        ROOT, "testdata", gold[ra]["bitstream"]), "rb").read())
    md5 = ABI.md5_of(pics, gold[ra].get("bitdepth", 8))
    if md5 != gold[ra]["decoded_yuv_md5"] or hash_ok != 1 or \
            len(pics) != gold[ra]["frames"]:
        raise AssertionError(f"libhmdec.so {ra}: {len(pics)} pictures, MD5 "
                             f"{md5}, hash check {hash_ok}")
    log(f"host: libhmdec.so (libHMDec_get_version "
        f"{lib.libHMDec_get_version().decode()}) pushed {ra} NAL by NAL: "
        f"{len(pics)} "
        f"pictures, MD5 matches golden, its MD5 SEI check OK")
    for name in ("mono16_ra_160x96", "rext444_16b_intra_160x96", HBD_WP):
        e = ports[name]
        t0 = time.monotonic()
        pics, hash_ok = ABI.decode(lib, open(os.path.join(
            ROOT, "testdata", e["bitstream"]), "rb").read())
        secs = time.monotonic() - t0
        md5 = ABI.md5_of(pics, e["bitdepth"])
        top = max(int(p.max()) for _, pl in pics for p in pl)
        if md5 != e["decoded_yuv_md5"] or hash_ok != 1 or \
                len(pics) != e["frames"]:
            raise AssertionError(f"libhmdec.so {name}: {len(pics)} pictures"
                                 f", MD5 {md5}, hash check {hash_ok}")
        log(f"host: libhmdec.so pushed {name} ({e['bitdepth']} bits, "
            f"{e['chroma']}) NAL by NAL: {len(pics)} pictures in "
            f"{secs:.3f} s, MD5 matches port_streams.json, its MD5 SEI check"
            f" OK, largest sample {top}")
    log(f"host phase: {time.monotonic() - t_phase:.1f} s")


def main():
    global CORE_OPS, cuda_ms, device_ms
    start = time.monotonic()
    if not os.path.isdir(os.path.join(ROOT, "libhm_tpu_torch")) or \
            not os.path.isdir(os.path.join(ROOT, "testdata")):
        sys.exit("chip_smoke: run from the root of a checkout of the repo")
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false")
    from libhm_tpu_torch.utils import timing as TM
    cuda_ms, device_ms = TM.cuda_ms, TM.device_ms
    card = TM.card_name()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    CORE_OPS = TM.int32_ops_per_s()
    log(f"bounds: HBM {HBM_BPS / 1e12:.2f} TB/s, int32 {CORE_OPS / 1e12:.3f} "
        f"T ops/s ({TM.INT32_LANES_PER_SM} lanes x 2 x "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs x "
        "the maximum SM clock)")

    # ---- build: the host parser and the kernels at once ----
    from libhm_tpu_torch.hostdec import native_bridge
    from libhm_tpu_torch.kernels import build as KB
    t0 = time.monotonic()
    native = subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " from libhm_tpu_torch.hostdec import native_bridge as nb;"
         " nb.build()", ROOT])
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import libhmdec_abi as ABI
    abi_build = subprocess.Popen(ABI.build_cmd())
    ptxas = KB.build(verbose=True)
    KB.library()
    log(f"kernel build (nvcc, {len(KB._sources())} sources in parallel): "
        f"{time.monotonic() - t0:.1f} s")
    for line in ptxas.splitlines():
        if "Compiling entry" in line or "Used" in line:
            log("  " + line.strip())
    if native.wait() != 0:
        raise RuntimeError("native host parser build failed")
    native_bridge.build()
    log(f"native host parser build (alongside): "
        f"{time.monotonic() - t0:.1f} s")
    if abi_build.wait() != 0:
        raise RuntimeError("libhmdec.so build failed")
    log(f"libhmdec.so build, the port's libHMDec C ABI (alongside): "
        f"{time.monotonic() - t0:.1f} s")

    # ---- kernels vs plain versions at main-path shapes ----
    from libhm_tpu_torch.hostdec.decoder import Decoder
    gold = json.load(open(os.path.join(ROOT, "testdata", "golden.json")))
    intra_data = open(os.path.join(ROOT, "testdata",
                                   gold[INTRA]["bitstream"]), "rb").read()
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(intra_data)
    items = dec.collected
    log(f"{INTRA}: intra blocks per picture "
        f"{[len(it['pic'].intra_list) for it in items]}")
    ports = json.load(open(os.path.join(ROOT, "testdata",
                                        "port_streams.json")))
    tools_data = open(os.path.join(ROOT, "testdata",
                                   ports[TOOLS]["bitstream"]), "rb").read()
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(tools_data)
    tool_items = dec.collected
    data = open(os.path.join(ROOT, "testdata", gold[STREAM]["bitstream"]),
                "rb").read()
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(data)
    from libhm_tpu_torch.parallel.dag_decode import reference_levels
    ra_levels = reference_levels(dec.collected)
    tool_levels = reference_levels(tool_items)
    rng = np.random.default_rng(2024)
    results = {}
    results["residual_scatter"] = check_k1(ra_levels, card, rng)
    results["residual_scatter_scaled"] = check_k1(
        tool_levels, card, rng, "residual_scatter_scaled")
    results["residual_bypass"] = check_k1(tool_levels, card, rng,
                                          "residual_bypass", bypass=True)
    results["loop_filter_level"], results["lf_picture"] = check_lf(
        ra_levels, tool_levels, card, rng)
    rt_us = l2_round_trip_us(card)
    results["intra_wavefront"], results["row14"] = check_k2(items, card, rng,
                                                            rt_us)
    results.update(check_k3(card, rng))
    results.update(check_k3(card, rng, bd=12))
    results["sao_apply"] = check_k4(card, rng)
    results["sao_apply_multi"] = check_k4_multi(tool_items, card, rng)
    results["mc_grid"] = check_k5(card, rng)
    results["mc_weighted"] = check_k6(card, rng)
    results["plane_checksum"] = check_k7(card, rng)
    results["restore_unfiltered"] = check_k8(card, rng)
    results["pcm_level"] = check_k9(card, rng)
    results["residual_table_ccp"] = check_k10(card, rng)
    # rows 14 and 15 of the kernel table: the per-picture path's shapes
    # (one picture: the intra wavefront of a whole 1080p picture; MC of
    # one picture; deblocking and SAO are per picture already)
    results["row15"] = check_k5(card, rng, B=1)
    v = results.pop("lf_picture")
    results["row15"].add(v.err, v.ms, v.plain_ms, v.bytes, v.ops)
    # the chroma geometries of the RExt path: 4:2:2 (chroma 960x1088) and
    # 4:4:4 (1920x1088).  Their errors join the kernels' lines; the times
    # there stay those of the 4:2:0 shapes above, comparable across runs
    rext = [check_k3(card, rng, sx=1, sy=0, with_luma=False),
            check_k3(card, rng, sx=0, sy=0, with_luma=False),
            {"sao_apply": check_k4(card, rng, sx=1, sy=0, with_luma=False)},
            {"sao_apply": check_k4(card, rng, sx=0, sy=0, with_luma=False)},
            {"mc_grid": check_k5(card, rng, comps=REXT_COMPS)}]
    for extra in rext:
        for k, v in extra.items():
            results[k].err = max(results[k].err, v.err)
    # the hbd phase's kernels: 16 bits (K5 and K6 also 14), errors joined
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(open(os.path.join(ROOT, "testdata",
                                        ports[HBD]["bitstream"]), "rb").read())
    check_hbd(results, ra_levels, tool_levels, items, dec.collected, card,
              rng, rt_us)
    results["residual_table_ext"] = check_ext(card, rng)
    del tool_items, ra_levels, tool_levels, dec
    bad = {k: v.err for k, v in results.items() if v.err != 0}
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")

    # ---- the main paths, counters reset just before each ----
    from libhm_tpu_torch.parallel import dag_decode as DD
    from libhm_tpu_torch.utils import xfer
    kernels = kernel_counters()[0]

    launches = {}
    # the per-picture path: HmDecoder (push a NAL, pull pictures), each
    # picture reconstructed on the card as soon as it is parsed
    _, counts = run_path(f"{STREAM} HmDecoder",
                         lambda: picture_main_path(data, gold, card),
                         K1_K4 + ["mc_grid"])
    launches["row14"] = counts["intra_wavefront"]
    launches["row15"] = counts["mc_grid"] + counts["loop_filter_level"]
    for name, modes in PICTURE_SMALL.items():
        table = ports if name in ports else gold
        stream = open(os.path.join(ROOT, "testdata", table[name]["bitstream"]),
                      "rb").read()
        xfer.reset()
        (dec, pics, _, secs), counts = run_path(
            f"{name} HmDecoder", lambda: push_decode(stream, sei_check=True),
            ["intra_wavefront"] + modes)
        check_exact(f"{name} HmDecoder", stream, counts, per_picture=True)
        statuses = [p.hash_status for p in pics]
        if len(pics) != table[name]["frames"] or (
                statuses != ["OK"] * len(pics) if name == FIELD
                else pics_md5(pics) != table[name]["decoded_yuv_md5"]):
            raise AssertionError(f"{name} through HmDecoder: {len(pics)} "
                                 f"pictures, hash SEIs {statuses}")
        log(f"{name} through HmDecoder: {len(pics)} pictures in {secs:.3f} "
            f"s, {'every hash SEI OK' if name == FIELD else 'MD5 matches'}")
    for name in SWEEP:
        stream = open(os.path.join(ROOT, "testdata", gold[name]["bitstream"]),
                      "rb").read()
        (dec, pics, _, secs), _ = run_path(
            f"{name} HmDecoder", lambda: push_decode(stream, sei_check=True),
            ["residual_scatter", "intra_wavefront"])
        if len(pics) != gold[name]["frames"] or \
                pics_md5(pics) != gold[name]["decoded_yuv_md5"]:
            raise AssertionError(f"{name} through HmDecoder: {len(pics)} "
                                 "pictures, MD5 mismatch")
        log(f"{name} through HmDecoder: {len(pics)} pictures in {secs:.3f} "
            "s, MD5 matches")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    (n, outs), counts = run_path(f"{UHD} decode_batch",
                                 lambda: decode_md5(UHD, gold),
                                 K1_K4 + ["mc_grid"])
    secs = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() - base
    # what decode_batch holds by design: every picture's int32 planes and
    # int16 copy, one level's residual, planes and SAO output, a reference
    # stack as deep as the DPB, and 256 MiB of maps and scratch
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(open(os.path.join(ROOT, "testdata",
                                        gold[UHD]["bitstream"]), "rb").read())
    sps = dec.collected[0]["sps"]
    del dec
    dpb = sps.max_dec_pic_buffering[sps.max_sub_layers_minus1]
    pic_bytes = (sps.pic_height_ctbs << sps.log2_ctb) * \
        (sps.pic_width_ctbs << sps.log2_ctb) * 4 * 3 // 2
    cap = int((n * 1.5 + 3 + dpb) * pic_bytes) + (256 << 20)
    log(f"{UHD} decode_batch ({card}): {n} pictures, MD5 matches golden, "
        f"{secs:.3f} s with the parse ({n / secs:.3f} fps); K2 "
        f"{counts['intra_wavefront']} launches; peak device memory "
        f"{peak / 1e6:.1f} MB above the {base / 1e6:.1f} MB before it, cap "
        f"{cap / 1e6:.1f} MB = ({n} x 1.5 + 3 + DPB {dpb}) x "
        f"{pic_bytes / 1e6:.3f} MB + 256 MiB")
    if peak > cap:
        raise AssertionError(f"{UHD}: peak device memory {peak} over {cap}")
    del outs
    uhd = open(os.path.join(ROOT, "testdata", gold[UHD]["bitstream"]),
               "rb").read()
    run_path(f"{UHD} HmDecoder",
             lambda: picture_main_path(uhd, gold, card, name=UHD),
             K1_K4 + ["mc_grid"])
    with tempfile.TemporaryDirectory(dir=KB.BUILD) as tmp:
        yuv = os.path.join(tmp, "out.yuv")
        r = subprocess.run(
            [sys.executable, "-m", "libhm_tpu_torch.apps.dec_app", "-b",
             os.path.join("testdata", gold[DEC_APP]["bitstream"]), "-o", yuv,
             "--sei-check"], cwd=ROOT, capture_output=True, text=True,
            timeout=600)
        md5 = hashlib.md5(open(yuv, "rb").read()).hexdigest() \
            if r.returncode == 0 else None
    if md5 != gold[DEC_APP]["decoded_yuv_md5"]:
        raise AssertionError(f"dec_app on {DEC_APP}: exit {r.returncode}, "
                             f"MD5 {md5}\n{r.stdout[-2000:]}{r.stderr[-2000:]}")
    log(f"dec_app on {DEC_APP} (subprocess, exit 0): YUV MD5 matches golden;"
        f" {r.stdout.strip().splitlines()[-1]}")
    from libhm_tpu_torch.parallel.batch_decode import decode_intra_batch
    dps, _ = run_path(f"{INTRA} decode_intra_batch",
                      lambda: decode_intra_batch(intra_data,
                                                 check_sei_hash=True),
                      K1_K4)
    md5 = hashlib.md5(b"".join(p.tobytes() for dp in dps
                               for p in dp.cropped())).hexdigest()
    statuses = [dp.hash_status for dp in dps]
    if md5 != gold[INTRA]["decoded_yuv_md5"] or \
            statuses != ["OK"] * gold[INTRA]["frames"]:
        raise AssertionError(f"decode_intra_batch {INTRA}: MD5 {md5}, hash "
                             f"SEIs {statuses}")
    log(f"decode_intra_batch {INTRA}: MD5 matches golden, every hash SEI OK")
    del dps
    (results["row16"], step), _ = run_path(
        "entry() fused_recon_step", lambda: check_fused(card),
        ["residual_scatter", "mc_weighted", "loop_filter_level",
         "plane_checksum"])
    launches["row16"] = sum(step.values())
    if results["row16"].err:
        raise AssertionError("fused_recon_step differs from its plain version")

    capture = LevelCapture()
    try:
        (npics, ra_outs), counts = run_path(
            f"{STREAM} decode_batch", lambda: decode_md5(STREAM, gold),
            K1_K4 + ["mc_grid"])
    finally:
        capture.remove()
    check_real_level(capture, card)
    del capture
    log(f"{STREAM}: {npics} pictures, MD5 matches golden")
    launches.update({k: counts[k] for k in K1_K4 + ["mc_grid"] +
                     SINGLE_PASS})
    (n, _), counts = run_path(f"{WP} decode_batch",
                              lambda: decode_md5(WP, gold), ["mc_weighted"])
    launches["mc_weighted"] = counts["mc_weighted"]
    _, dev = device_events(lambda: decode_md5(WP, gold))
    k6_ms, k6_n = dev_sum(dev, "mc_weighted")
    log(f"{WP}: {n} pictures, MD5 matches golden; K6 {counts['mc_weighted']}"
        f" launches, {k6_ms:.4f} ms device over the decode ({k6_n} kernels "
        f"seen under torch.profiler) ({card})")

    xfer.reset()
    (parse_s, comp_s, csum, n), counts = run_path(
        f"{STREAM} decode_batch_device",
        lambda: DD.decode_batch_device(data, device="cuda"),
        K1_K4 + ["mc_grid", "plane_checksum"])
    want = DD.cropped_checksum(ra_outs)
    if csum != want or n != npics or xfer.D2H != 4 or \
            "checksum" in xfer.BY_TAG or counts["plane_checksum"] != 1:
        raise AssertionError(f"decode_batch_device: checksum {csum} vs "
                             f"{want}, {n} pictures, {xfer.D2H} bytes down, "
                             f"uploads {xfer.BY_TAG}, "
                             f"{counts['plane_checksum']} K7 launches")
    launches["plane_checksum"] = counts["plane_checksum"]
    _, dev = device_events(lambda: DD.decode_batch_device(data, device="cuda"))
    h2d_n = dev_sum(dev, "HtoD")[1]
    log(f"decode_batch_device {STREAM} ({card}): checksum {csum} equals "
        f"cropped_checksum; parse {parse_s:.3f} s, device recon + checksum "
        f"{comp_s:.3f} s, {n / (parse_s + comp_s):.2f} fps, D2H "
        f"{xfer.D2H} bytes, H2D {xfer.H2D / n / 1e6:.3f} MB/picture by tag "
        f"{sorted(xfer.BY_TAG)}; K7 1 launch; H2D memcpy {h2d_n} (a second "
        "run, torch.profiler)")
    del ra_outs

    for name in (INTRA,) + SMALL:
        (n, _), _ = run_path(f"{name} decode_batch",
                             lambda: decode_md5(name, gold), K1_K4)
        log(f"{name}: {n} pictures, MD5 matches golden")

    # the tools path: several slices and tiles, scaling lists (1080p), then
    # the small slice/tile/PCM/lossless/scaling streams
    (n, tool_outs), counts = run_path(
        f"{TOOLS} decode_batch",
        lambda: decode_md5(TOOLS, ports, check_sei_hash=True),
        ["residual_scatter_scaled", "intra_wavefront", "loop_filter_level",
         "loop_filter_multi", "mc_grid"])
    log(f"{TOOLS}: {n} pictures, MD5 matches port_streams.json")
    launches["residual_scatter_scaled"] = counts["residual_scatter_scaled"]
    xfer.reset()
    (parse_s, comp_s, csum, n), _ = run_path(
        f"{TOOLS} decode_batch_device",
        lambda: DD.decode_batch_device(tools_data, device="cuda"),
        ["residual_scatter_scaled", "loop_filter_multi", "plane_checksum"])
    want = DD.cropped_checksum(tool_outs)
    if csum != want or n != len(tool_outs) or xfer.D2H != 4:
        raise AssertionError(f"{TOOLS} decode_batch_device: checksum {csum} "
                             f"vs {want}, {n} pictures, {xfer.D2H} bytes")
    log(f"decode_batch_device {TOOLS} ({card}): checksum {csum} equals "
        f"cropped_checksum; parse {parse_s:.3f} s, device recon + checksum "
        f"{comp_s:.3f} s")
    del tool_outs
    for name, modes in TOOL_SMALL.items():
        table = ports if name in ports else gold
        xfer.reset()
        (n, _), counts = run_path(
            f"{name} decode_batch", lambda: decode_md5(name, table),
            ["intra_wavefront", "loop_filter_level"] + modes)
        check_exact(f"{name} decode_batch", open(os.path.join(
            ROOT, "testdata", table[name]["bitstream"]), "rb").read(), counts)
        for k, src in LAUNCHES_FROM.items():
            if src == name:
                launches[k] = counts[k]
        log(f"{name}: {n} pictures, MD5 matches "
            f"{'port_streams.json' if table is ports else 'golden'}")

    # the RExt path: Main 4:2:2 10 at 1080p (port_streams.json), then the
    # 4:2:2 / 4:4:4 (CCP) / 4:0:0 / 12-bit goldens, then decode_streams
    rext_data = open(os.path.join(ROOT, "testdata",
                                  ports[REXT]["bitstream"]), "rb").read()
    (n, rext_outs), counts = run_path(
        f"{REXT} decode_batch",
        lambda: decode_md5(REXT, ports, check_sei_hash=True),
        K1_K4 + ["mc_grid"])
    log(f"{REXT}: {n} pictures, MD5 matches port_streams.json")
    xfer.reset()
    (parse_s, comp_s, csum, n), _ = run_path(
        f"{REXT} decode_batch_device",
        lambda: DD.decode_batch_device(rext_data, device="cuda"),
        K1_K4 + ["mc_grid", "plane_checksum"])
    want = DD.cropped_checksum(rext_outs)
    if csum != want or n != len(rext_outs) or xfer.D2H != 4:
        raise AssertionError(f"{REXT} decode_batch_device: checksum {csum} "
                             f"vs {want}, {n} pictures, {xfer.D2H} bytes")
    log(f"decode_batch_device {REXT} ({card}): checksum {csum} equals "
        f"cropped_checksum; parse {parse_s:.3f} s, device recon + checksum "
        f"{comp_s:.3f} s")
    del rext_outs
    for name, modes in REXT_SMALL.items():
        xfer.reset()
        (n, _), counts = run_path(f"{name} decode_batch",
                                  lambda: decode_md5(name, gold),
                                  ["intra_wavefront"] + modes)
        check_exact(f"{name} decode_batch", open(os.path.join(
            ROOT, "testdata", gold[name]["bitstream"]), "rb").read(), counts)
        for k, src in LAUNCHES_FROM.items():
            if src == name:
                launches[k] = counts[k]
        log(f"{name}: {n} pictures, MD5 matches golden")
    multi = [gold[nm]["bitstream"] for nm in MULTI]
    outs, _ = run_path(
        "decode_streams " + " + ".join(MULTI),
        lambda: DD.decode_streams(
            [open(os.path.join(ROOT, "testdata", b), "rb").read()
             for b in multi], device="cuda", threads=2),
        K1_K4 + ["mc_grid"])
    for nm, o in zip(MULTI, outs):
        md5 = hashlib.md5(b"".join(p.tobytes() for pic in o
                                   for p in pic)).hexdigest()
        if len(o) != gold[nm]["frames"] or md5 != gold[nm]["decoded_yuv_md5"]:
            raise AssertionError(f"decode_streams: {nm} MD5 {md5}")
    log(f"decode_streams: {len(MULTI)} streams in one reconstruction, each "
        "MD5 matches golden")
    del outs
    hbd_phase(ports, card)
    launches["residual_table_ext"] = extprec_phase(ports, card)
    multidevice_phase(gold, card)
    enc = encoder_phase(gold, card)
    pcm_flush_phase(card)
    host_phase(gold, ports)

    # ---- timed runs: parse and device phases ----
    timed_run(STREAM, data, gold[STREAM]["decoded_yuv_md5"], card)
    statuses = timed_run(TOOLS, tools_data, ports[TOOLS]["decoded_yuv_md5"],
                         card, check_sei_hash=True)
    if statuses != ["OK"] * ports[TOOLS]["frames"]:
        raise AssertionError(f"{TOOLS}: hash SEI statuses {statuses}")
    log(f"{TOOLS}: every picture's hash SEI checks OK")
    statuses = timed_run(REXT, rext_data, ports[REXT]["decoded_yuv_md5"],
                         card, check_sei_hash=True)
    if statuses != ["OK"] * ports[REXT]["frames"]:
        raise AssertionError(f"{REXT}: hash SEI statuses {statuses}")
    log(f"{REXT}: every picture's hash SEI checks OK")

    breakdown(data, card)
    bench_phase(data, card)

    src = {"residual_scatter": ("libhm_tpu_torch/csrc/residual.cu",
                                "libhm_tpu/recon_tpu.py:60"),
           "intra_wavefront": ("libhm_tpu_torch/csrc/intra.cu",
                           "libhm_tpu/parallel/batch_decode.py:266"),
           "loop_filter_level": ("libhm_tpu_torch/csrc/loopfilter.cu",
                                 "libhm_tpu/parallel/device_filters.py:102"),
           "deblock_luma": ("libhm_tpu_torch/csrc/loopfilter.cu",
                            "libhm_tpu/ops/deblock.py:28"),
           "deblock_chroma": ("libhm_tpu_torch/csrc/loopfilter.cu",
                              "libhm_tpu/ops/deblock.py:136"),
           "sao_apply": ("libhm_tpu_torch/csrc/loopfilter.cu",
                         "libhm_tpu/ops/sao.py:19"),
           "mc_grid": ("libhm_tpu_torch/csrc/mc.cu",
                       "libhm_tpu/parallel/dag_decode.py:190"),
           "mc_weighted": ("libhm_tpu_torch/csrc/mc.cu",
                           "libhm_tpu/parallel/dag_decode.py:73"),
           "plane_checksum": ("libhm_tpu_torch/csrc/checksum.cu",
                              "libhm_tpu/parallel/dag_decode.py:620"),
           "residual_scatter_scaled": ("libhm_tpu_torch/csrc/residual.cu",
                                       "libhm_tpu/ops/transform.py:81"),
           "residual_bypass": ("libhm_tpu_torch/csrc/residual.cu",
                               "libhm_tpu/recon_tpu.py:63"),
           "sao_apply_multi": ("libhm_tpu_torch/csrc/loopfilter.cu",
                               "libhm_tpu/parallel/device_filters.py:169"),
           "restore_unfiltered": ("libhm_tpu_torch/csrc/pcm.cu",
                                  "libhm_tpu/parallel/device_filters.py:191"),
           "pcm_level": ("libhm_tpu_torch/csrc/pcm.cu",
                         "libhm_tpu/parallel/dag_decode.py:483"),
           "deblock_chroma16": ("libhm_tpu_torch/csrc/loopfilter.cu",
                                "libhm_tpu/ops/deblock.py:136"),
           "residual_table_ccp": ("libhm_tpu_torch/csrc/residual.cu",
                                  "libhm_tpu/parallel/batch_decode.py:164"),
           "residual_table_ext": ("libhm_tpu_torch/csrc/residual.cu",
                                  "libhm_tpu/recon_tpu.py:60")}
    def row(name, source, replaces, n, r):
        bound_ms, bound_by = r.bound()
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n, "max_abs_err": r.err,
                "ms": round(r.ms, 4), "plain_ms": round(r.plain_ms, 4),
                "bound_ms": float(f"{bound_ms:.4g}"), "bound_by": bound_by,
                "library_ms": None if r.library_ms is None
                else round(r.library_ms, 4)}
    rows = [row(name, *src[name], launches[name], results[name])
            for name in kernels]
    rows += [row(name, source, replaces, launches[key], results[key])
             for key, name, source, replaces in ROWS]
    rows += [row(name, source, replaces, enc[key][1], enc[key][0])
             for key, name, source, replaces in ENC_ROWS]
    log(f"chip_smoke: {time.monotonic() - start:.1f} s from the start to "
        f"the result ({card})")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
