"""Make an extended-precision stream (RExt extended_precision_processing_flag
= 1) from a RExt stream of testdata/.

    python tools/make_extprec_stream.py NAME [NAME ...] [--md5]

For each NAME (a stream of testdata/port_streams.json or golden.json):

1. every SPS NAL gets extended_precision_processing_flag set in its RBSP
   (the fifth bit before the rbsp_stop_one_bit where the SPS ends with
   sps_range_extension(); where it has no extension at all, a range
   extension whose only set flag is this one), and its EBSP is rebuilt
   with emulation prevention; the SPS must parse back with the flag set
   and every other field as it was;
2. the port's native parse (libhm_tpu_torch.hostdec, recon="collect") of
   the stream with and without the bit must give every TU the same
   coefficients, position, size and modes.  In coeff_abs_level_remaining
   the limited-prefix binarization of the flag reads the same bits, and
   gives the same value, as the plain EGk one for every prefix shorter
   than 32 - max_dyn_range + 3 (H.265 9.3.3.11), so a stream whose
   prefixes stay short parses alike, and only dequantization and the
   inverse transform change.  The stream is refused otherwise;
3. testdata/NAME_extprec.bin is written.

--md5 also decodes the new stream with decode_batch(device="cpu") and with
Decoder(parse="python", recon="numpy") (whose residual follows H.265 at
max_dyn_range max(15, bd + 6), hostdec/refimpl.py), requires both MD5s to
agree, and records the stream in testdata/port_streams.json.  The stream's
decoded-picture-hash SEIs hash the decode without the flag, so they
mismatch by design; no HM decode is its oracle.
"""
import argparse
import hashlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from libhm_tpu_torch.hostdec import nal as N  # noqa: E402
from libhm_tpu_torch.hostdec.bitstream import \
    strip_emulation_prevention  # noqa: E402
from libhm_tpu_torch.hostdec.params import parse_sps  # noqa: E402

TESTDATA = os.path.join(ROOT, "testdata")
PORTS = os.path.join(TESTDATA, "port_streams.json")
_TU_FIELDS = ("comp", "x", "y", "w", "qp", "transform_skip", "tq_bypass",
              "use_dst", "rdpcm_mode", "cross_comp_alpha")


def add_emulation_prevention(rbsp):
    """RBSP -> EBSP: a 0x03 after every two zero bytes that precede a byte
    of 3 or less (H.265 7.4.2)."""
    out, zeros = bytearray(), 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


# the flags of sps_range_extension() in syntax order (H.265 7.3.2.2.2),
# as the SPS attributes they parse into
RANGE_FLAGS = ("transform_skip_rotation", "transform_skip_context",
               "implicit_rdpcm", "explicit_rdpcm", "extended_precision",
               "intra_smoothing_disabled", "high_precision_offsets",
               "persistent_rice_adaptation", "cabac_bypass_alignment")


def set_range_flag(rbsp, name):
    """The SPS RBSP with the range-extension flag `name` (of RANGE_FLAGS)
    set: its bit among the nine before the rbsp_stop_one_bit where the SPS
    ends with sps_range_extension(), else, where it has no extension (its
    last bit sps_extension_present_flag = 0), in place of that bit
    sps_extension_present_flag = 1, sps_range_extension_flag = 1, no other
    extension (multilayer, 3d, 5 bits) and a range extension with that
    flag alone.  Raises unless the result parses back with the flag and
    every other field unchanged."""
    before = parse_sps(rbsp)
    if getattr(before, name):
        raise ValueError(f"the SPS sets {name} already")
    i = RANGE_FLAGS.index(name)
    bits = np.unpackbits(np.frombuffer(rbsp, np.uint8))
    stop = int(np.nonzero(bits)[0][-1])           # rbsp_stop_one_bit
    flipped = bits[:stop + 1].copy()
    flipped[stop - 9 + i] = 1
    ext = [1, 1] + [0] * 7 + [int(j == i) for j in range(9)]
    inserted = np.concatenate([bits[:stop - 1], ext, [1]])
    tried = []
    for cand in (flipped, inserted):
        out = np.packbits(cand.astype(np.uint8)).tobytes()
        try:
            after = parse_sps(out)
        except (EOFError, ValueError, IndexError) as e:
            tried.append(f"breaks the parse ({e})")
            continue
        changed = {k for k, v in vars(before).items()
                   if getattr(after, k) != v}
        if changed == {name}:
            return out
        tried.append(f"changes {sorted(changed)}")
    raise ValueError(f"neither a range extension's flag nor a new range "
                     f"extension sets {name}: " + "; ".join(tried))


def set_extended_precision(rbsp):
    """The SPS RBSP with extended_precision_processing_flag set."""
    return set_range_flag(rbsp, "extended_precision")


def rewrite_sps(data, edit):
    """The Annex-B stream `data` with every SPS NAL unit's RBSP rebuilt by
    edit(rbsp), with emulation prevention."""
    out, n = data, 0
    for ebsp in {e for e in N.split_annexb(data)
                 if N.parse_nal(e).nal_type == N.NAL_SPS}:
        rbsp = edit(strip_emulation_prevention(ebsp[2:]))
        new = ebsp[:2] + add_emulation_prevention(rbsp)
        if strip_emulation_prevention(new[2:]) != rbsp:
            raise AssertionError("emulation prevention did not round-trip")
        n += out.count(ebsp)
        out = out.replace(ebsp, new)
    if not n:
        raise ValueError("no SPS NAL in the stream")
    return out


def with_extended_precision(data):
    """The Annex-B stream `data` with every SPS NAL rebuilt by
    set_extended_precision."""
    return rewrite_sps(data, set_extended_precision)


def _tus(data):
    from libhm_tpu_torch.hostdec.decoder import Decoder
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(data)
    return [(it["sps"].extended_precision, it["pic"].tu_list)
            for it in dec.collected]


def same_coefficients(data, ext_data):
    """Number of TUs compared: raises unless the native parse gives every
    TU of ext_data what it gives the TU of data (and the flag is set in
    every picture of ext_data)."""
    a, b = _tus(data), _tus(ext_data)
    if len(a) != len(b) or not all(e for e, _ in b):
        raise ValueError(f"{len(a)} pictures without the flag, {len(b)} "
                         "with it, or a picture without the flag")
    count = 0
    for (_, ta), (_, tb) in zip(a, b):
        if len(ta) != len(tb):
            raise ValueError("the TU lists differ in length")
        for u, v in zip(ta, tb):
            if any(getattr(u, f) != getattr(v, f) for f in _TU_FIELDS) or \
                    not np.array_equal(u.coeffs, v.coeffs):
                raise ValueError(f"TU {count} parses differently with the "
                                 "flag")
            count += 1
    return count


def decoded_md5s(data):
    """(MD5 of decode_batch(device="cpu"), MD5 of Decoder(parse="python",
    recon="numpy")), over every decoded picture's cropped planes, and the
    picture count."""
    from libhm_tpu_torch.hostdec.decoder import Decoder
    from libhm_tpu_torch.parallel.dag_decode import decode_batch
    md5 = lambda pics: hashlib.md5(b"".join(  # noqa: E731
        p.tobytes() for pic in pics for p in pic)).hexdigest()
    port = decode_batch(data, device="cpu")
    ref = Decoder(parse="python", recon="numpy").decode_annexb(data)
    return md5(port), md5(ref), len(port)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="+")
    ap.add_argument("--md5", action="store_true",
                    help="decode it twice and record it in "
                         "port_streams.json")
    a = ap.parse_args(argv)
    ports = json.load(open(PORTS))
    gold = json.load(open(os.path.join(TESTDATA, "golden.json")))
    failed = 0
    for name in a.names:
        src = (ports.get(name) or gold[name])
        data = open(os.path.join(TESTDATA, src["bitstream"]), "rb").read()
        try:
            ext = with_extended_precision(data)
            tus = same_coefficients(data, ext)
        except ValueError as e:
            print(f"{name}: refused: {e}")
            failed += 1
            continue
        out = f"{name}_extprec"
        open(os.path.join(TESTDATA, out + ".bin"), "wb").write(ext)
        print(f"{name}: {tus} TUs parse alike with the flag; wrote "
              f"testdata/{out}.bin")
        if not a.md5:
            continue
        port, ref, frames = decoded_md5s(ext)
        if port != ref:
            print(f"{out}: decode_batch MD5 {port} != the numpy decoder's "
                  f"{ref}")
            failed += 1
            continue
        ports[out] = {
            "bitstream": out + ".bin", "w": src["w"], "h": src["h"],
            "frames": frames, "bitdepth": src["bitdepth"],
            "chroma": src["chroma"], "decoded_yuv_md5": port,
            "oracle": (
                f"{name}.bin with extended_precision_processing_flag set in "
                "its SPS by tools/make_extprec_stream.py, which checks that "
                "the port's native parse gives every TU the same "
                "coefficients with and without it; no HM decode: this MD5 "
                "is what Decoder(parse='python', recon='numpy') (H.265's "
                "residual at max_dyn_range max(15, bd + 6)) and the port's "
                "decode_batch(device='cpu') both give. The hash SEIs hash "
                "the decode without the flag, so they mismatch by design")}
        with open(PORTS, "w") as f:
            json.dump(ports, f, indent=1)
            f.write("\n")
        print(f"{out}: MD5 {port} from both decoders; recorded in "
              "testdata/port_streams.json")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
