# Copied from libhm_tpu/apps/annexb_bytecount.py
"""Per-NAL-type byte accounting (utils/annexBbytecount.cpp equivalent)."""
import argparse
import sys
from collections import Counter

from ..hostdec import nal as N

NAMES = {0: "TRAIL_N", 1: "TRAIL_R", 8: "RASL_N", 9: "RASL_R",
         19: "IDR_W_RADL", 20: "IDR_N_LP", 21: "CRA", 32: "VPS", 33: "SPS",
         34: "PPS", 35: "AUD", 36: "EOS", 39: "PREFIX_SEI", 40: "SUFFIX_SEI"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("bitstream")
    args = ap.parse_args(argv)
    data = open(args.bitstream, "rb").read()
    counts = Counter()
    sizes = Counter()
    for ebsp in N.split_annexb(data):
        t = (ebsp[0] >> 1) & 0x3F
        counts[t] += 1
        sizes[t] += len(ebsp)
    for t in sorted(counts):
        print(f"type {t:2d} {NAMES.get(t, '?'):12s} count {counts[t]:5d} "
              f"bytes {sizes[t]:9d}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
