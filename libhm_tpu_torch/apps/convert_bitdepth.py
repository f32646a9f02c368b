# Copied from libhm_tpu/apps/convert_bitdepth.py
"""Raw YUV bit-depth conversion (utils/convert_NtoMbit_YCbCr.cpp equivalent)."""
import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--in-depth", type=int, default=8)
    ap.add_argument("--out-depth", type=int, default=10)
    args = ap.parse_args(argv)
    dt_in = np.uint8 if args.in_depth <= 8 else np.uint16
    data = np.fromfile(args.input, dt_in).astype(np.int32)
    shift = args.out_depth - args.in_depth
    if shift >= 0:
        out = data << shift
    else:
        out = (data + (1 << (-shift - 1))) >> (-shift)
    maxv = (1 << args.out_depth) - 1
    out = np.clip(out, 0, maxv)
    dt_out = np.uint8 if args.out_depth <= 8 else np.uint16
    out.astype(dt_out).tofile(args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
