# Copied from libhm_tpu/apps/enc_app.py
"""Encoder application (TAppEncoder equivalent).

Mirrors the reference app's CLI + config-file system (reference:
source/App/TAppEncoder/TAppEncCfg.cpp, TAppCommon/program_options_lite):
`-c cfg` files stack (later wins), `Key=value` arguments override, and the
short options (-i/-b/-wdt/-hgt/-f/-q/-fr) override everything.

    python -m libhm_tpu_torch.apps.enc_app -c encoder_randomaccess_main.cfg \
        -c per-sequence/BQSquare.cfg -i in.yuv -b out.bin -f 17
    python -m libhm_tpu_torch.apps.enc_app -i in.yuv -b out.bin -wdt 416 \
        -hgt 240 -f 3 [--device cuda|cpu]

The in-loop filter runs on the card (--device, default cuda); --device cpu
runs the loop-filter kernel's plain torch version instead.
"""
import argparse
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="libhm_tpu_torch HEVC encoder",
        epilog="Trailing Key=value arguments override cfg-file options.")
    ap.add_argument("-c", "--config", action="append", default=[],
                    help="HM-style cfg file (repeatable; later wins)")
    ap.add_argument("-i", "--input", default=None)
    ap.add_argument("-b", "--bitstream", default=None)
    ap.add_argument("-o", "--recon", default=None)
    ap.add_argument("-wdt", type=int, default=None)
    ap.add_argument("-hgt", type=int, default=None)
    ap.add_argument("-f", "--frames", type=int, default=None)
    ap.add_argument("-q", "--qp", type=int, default=None)
    ap.add_argument("--cu-size", type=int, default=None)
    ap.add_argument("--gop", choices=["intra", "lowdelayP", "lowdelayB",
                                      "randomaccess"], default=None,
                    help="built-in GOP structure (cfg files use the "
                         "FrameN GOP table instead)")
    ap.add_argument("--search-range", type=int, default=None)
    ap.add_argument("--rate", type=int, default=None,
                    help="target bitrate in kbps (R-lambda rate control)")
    ap.add_argument("-fr", "--frame-rate", type=float, default=None)
    ap.add_argument("-fs", "--frame-skip", type=int, default=None,
                    help="skip N source frames before encoding "
                         "(TAppEncCfg FrameSkip)")
    ap.add_argument("--input-colour-space-convert", default="UNCHANGED",
                    choices=["UNCHANGED", "YCbCrtoYCrCb", "YCbCrtoYYY",
                             "RGBtoGBR"],
                    help="input colour-space conversion (TAppEncCfg "
                         "InputColourSpaceConvert; reference "
                         "TComChromaFormat.cpp:42-69)")
    ap.add_argument("--device", default="cuda",
                    help="device of the in-loop filter (default cuda)")
    args, extra = ap.parse_known_args(argv)

    from ..encoder.encoder import IntraEncoder, EncoderConfig
    if args.config:
        from ..encoder.options import parse_cfg_files, HmConfig
        opts = parse_cfg_files(args.config,
                               [e for e in extra if "=" in e])
        hm = HmConfig(opts)
        cfg = hm.to_encoder_config()
        if args.qp is not None:
            cfg.qp = args.qp
        if args.wdt:
            cfg.width = args.wdt
        if args.hgt:
            cfg.height = args.hgt
        if args.frame_rate:
            cfg.fps = args.frame_rate
        if args.search_range:
            cfg.search_range = args.search_range
        if args.rate:
            cfg.rate_kbps = args.rate
        input_file = args.input or hm.get("input_file")
        bitstream_file = args.bitstream or hm.get("bitstream_file")
        recon_file = args.recon or hm.get("recon_file")
        nframes = args.frames if args.frames is not None \
            else hm.get("frames", 0)
        input_bd = hm.get("input_bit_depth", cfg.bit_depth)
    else:
        for req, name in ((args.input, "-i"), (args.bitstream, "-b"),
                          (args.wdt, "-wdt"), (args.hgt, "-hgt"),
                          (args.frames, "-f")):
            if req is None:
                ap.error(f"{name} is required without -c")
        cfg = EncoderConfig(args.wdt, args.hgt,
                            qp=args.qp if args.qp is not None else 32,
                            cu_size=args.cu_size or 32,
                            gop=args.gop or "intra",
                            search_range=args.search_range or 8,
                            rate_kbps=args.rate,
                            fps=args.frame_rate or 30.0)
        input_file, bitstream_file = args.input, args.bitstream
        recon_file = args.recon
        nframes = args.frames
        input_bd = cfg.bit_depth
    if not cfg.width or not cfg.height:
        ap.error("source dimensions unknown (use -wdt/-hgt or cfg "
                 "SourceWidth/SourceHeight)")
    if not nframes:
        ap.error("frame count unknown (use -f or cfg FramesToBeEncoded)")

    w, h = cfg.width, cfg.height
    mono = cfg.chroma_format_idc == 0
    ssx = 1 if cfg.chroma_format_idc in (1, 2) else 0
    ssy = 1 if cfg.chroma_format_idc == 1 else 0
    cw, ch = (0, 0) if mono else (w >> ssx, h >> ssy)
    dt_in = np.uint8 if input_bd <= 8 else np.dtype("<u2")
    raw = np.fromfile(input_file, dt_in)
    fsz = w * h + 2 * cw * ch
    skip = args.frame_skip if args.frame_skip is not None else \
        (hm.get("frame_skip", 0) if args.config else 0)
    if skip:
        raw = raw[skip * fsz:]
    frames = []
    for f in range(nframes):
        fr = raw[f * fsz:(f + 1) * fsz].astype(
            np.uint8 if cfg.bit_depth <= 8 else np.uint16)
        if input_bd != cfg.bit_depth:
            shift = cfg.bit_depth - input_bd
            fr = (fr.astype(np.int32) << shift).astype(
                np.uint8 if cfg.bit_depth <= 8 else np.uint16)
        if mono:
            frames.append((fr[:w * h].reshape(h, w),))
        else:
            frames.append((fr[:w * h].reshape(h, w),
                           fr[w * h:w * h + cw * ch].reshape(ch, cw),
                           fr[w * h + cw * ch:].reshape(ch, cw)))
    csc = args.input_colour_space_convert
    if csc != "UNCHANGED" and not mono:
        # plane permutations / replication before encoding (reference
        # TVideoIOYuv ipCSC; YYY requires 4:4:4 geometry)
        if csc == "YCbCrtoYCrCb":
            frames = [(y, v, u) for (y, u, v) in frames]
        elif csc == "YCbCrtoYYY":
            frames = [(y, y.copy(), y.copy()) for (y, u, v) in frames]
        elif csc == "RGBtoGBR":
            frames = [(g, b, r) for (r, g, b) in frames]
    t0 = time.monotonic()
    enc = IntraEncoder(cfg, device=args.device)
    stream = enc.encode_stream(frames)
    dt = time.monotonic() - t0
    open(bitstream_file, "wb").write(stream)
    print(f"encoded {nframes} frames -> {len(stream)} bytes "
          f"in {dt:.2f}s ({8*len(stream)*cfg.fps/nframes/1000:.1f} kbps)")
    # per-slice-type PSNR / bitrate summary (reference TEncAnalyze)
    from ..encoder.analyze import Analyze
    an = Analyze(fps=cfg.fps)
    for slice_type, bits, poc, recon in enc.stats:
        an.add_picture(slice_type, bits, frames[poc], recon, cfg.bit_depth)
    print(an.summary())
    if recon_file:
        with open(recon_file, "wb") as f:
            order = sorted(enc.stats, key=lambda s: s[2])
            for _, _, _, recon in order:
                for plane in recon:
                    f.write(plane.astype(
                        np.uint8 if cfg.bit_depth <= 8 else "<u2"
                    ).tobytes())
    return 0


if __name__ == "__main__":
    sys.exit(main())
