# Copied from libhm_tpu/apps/dec_app.py
"""Decoder application (TAppDecoder equivalent).

Mirrors the reference app's CLI surface (reference: source/App/TAppDecoder/
TAppDecCfg.cpp): -b bitstream, -o reconstruction YUV, -s skip frames,
-t max temporal layer, -d output bit depth.

    python -m libhm_tpu_torch.apps.dec_app -b in.bin -o out.yuv \
        [--recon {torch,numpy,native}] [--device cuda|cpu]

--recon torch (the default) reconstructs on the card; --device cpu runs
the same path on the CPU through the kernels' plain torch versions.
"""
import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description="libhm_tpu_torch HEVC decoder")
    ap.add_argument("-b", "--bitstream", required=True)
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--parse", choices=["python", "native"], default="native")
    ap.add_argument("--recon", choices=["torch", "numpy", "native"],
                    default="torch")
    ap.add_argument("--device", default="cuda",
                    help="device of --recon torch (default cuda)")
    ap.add_argument("-t", "--max-temporal-layer", type=int, default=-1)
    ap.add_argument("-d", "--output-bit-depth", type=int, default=0,
                    help="0 = native bit depth")
    ap.add_argument("--sei-check", action="store_true",
                    help="verify decoded-picture-hash SEIs")
    ap.add_argument("--print-sei", action="store_true",
                    help="dump decoded SEI messages (TAppDecTop's "
                         "outputDecodedSEIMessagesFilename equivalent)")
    ap.add_argument("-s", "--skip-frames", type=int, default=0,
                    help="number of decoded pictures to drop before "
                         "writing output (TAppDecCfg m_iSkipFrame)")
    ap.add_argument("--colour-space-convert", default="UNCHANGED",
                    choices=["UNCHANGED", "YCrCbtoYCbCr", "GBRtoRGB"],
                    help="output colour-space conversion for 4:4:4 "
                         "streams (TAppDecCfg OutputColourSpaceConvert; "
                         "reference TComChromaFormat.cpp:42-69)")
    ap.add_argument("--weave-fields", action="store_true",
                    help="pair even/odd-POC field pictures and write "
                         "row-interleaved frames (TAppDecTop field "
                         "output; parity from the pic_struct SEI). The "
                         "reference app only weaves pairs it recognises "
                         "mid-stream — this option weaves every pair")
    args = ap.parse_args(argv)

    import numpy as np
    from ..hostdec.decoder import Decoder
    from ..utils.trace import maybe_enable_decoder_trace
    maybe_enable_decoder_trace()   # HEVC_TRACE=<path> symbol trace
    data = open(args.bitstream, "rb").read()
    t0 = time.monotonic()
    dec = Decoder(parse=args.parse, recon=args.recon,
                  check_sei_hash=args.sei_check, device=args.device)
    outs = dec.decode_annexb(data)
    dt = time.monotonic() - t0
    for i, rec in enumerate(dec.output_records):
        status = ""
        if args.sei_check and rec.hash_status:
            status = f" [{rec.hash_status}]"
        print(f"POC {rec.poc:4d} TId: {rec.temporal_id}{status}")
    if args.print_sei:
        from ..hostdec import sei as S
        for is_suffix, ptype, obj in dec.sei_log:
            kind = "Suffix" if is_suffix else "Prefix"
            name = S.SEI_NAMES.get(ptype, f"type {ptype}")
            print(f"{kind} SEI: {name}")
            if not isinstance(obj, (bytes, bytearray)):
                for k, v in sorted(vars(obj).items()):
                    if isinstance(v, (bytes, bytearray)):
                        v = v.hex()
                    elif isinstance(v, list) and v and \
                            isinstance(v[0], (bytes, bytearray)):
                        v = [x.hex() for x in v]
                    print(f"  {k}: {v}")
    print(f"decoded {len(outs)} pictures in {dt:.3f}s ({len(outs)/dt:.2f} fps)")
    if args.output and args.weave_fields:
        from ..hostdec.fields import weave_fields
        frames = weave_fields(dec.output_records)
        with open(args.output, "wb") as f:
            for fr in frames:
                for plane in fr:
                    plane.tofile(f)
        return 0
    # output colour-space conversion: plane permutations, 4:4:4 only
    # (YCrCbtoYCbCr swaps the chroma planes; GBRtoRGB: coded (G,B,R)
    # planes written back out as R,G,B)
    perm = {"UNCHANGED": None, "YCrCbtoYCbCr": (0, 2, 1),
            "GBRtoRGB": (2, 0, 1)}[args.colour_space_convert]
    if perm is not None:
        outs = [tuple(pic[i] for i in perm) if len(pic) == 3 else pic
                for pic in outs]
    if args.skip_frames:
        outs = outs[args.skip_frames:]
        dec.output_records = dec.output_records[args.skip_frames:]
    if args.output:
        with open(args.output, "wb") as f:
            for pic, rec in zip(outs, dec.output_records):
                for c, plane in enumerate(pic):
                    if args.output_bit_depth:
                        src_bd = rec.sps.bit_depth_luma if c == 0 \
                            else rec.sps.bit_depth_chroma
                        shift = args.output_bit_depth - src_bd
                        p = plane.astype(np.int32)
                        if shift >= 0:
                            p = p << shift
                        else:
                            p = (p + (1 << (-shift - 1))) >> (-shift)
                        dt_out = np.uint8 if args.output_bit_depth <= 8 \
                            else np.uint16
                        np.clip(p, 0, (1 << args.output_bit_depth) - 1) \
                            .astype(dt_out).tofile(f)
                    else:
                        plane.tofile(f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
