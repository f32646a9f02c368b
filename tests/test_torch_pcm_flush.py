"""PCM samples after the arithmetic coder's flush (ROADMAP C13), on the CPU.

After pcm_flag the encoder flushes the arithmetic coder (H.265 9.3.4.3.5:
its last bit is the 1 of WriteBits(((ivlLow >> 7) & 3) | 1, 2)) and writes
pcm_alignment_zero_bits only while it is not byte-aligned.  The decoder's
engine has read 9 bits at its start and one a renormalising shift, so its
position after the terminate bin is just past that 1, and the samples
start at the next byte boundary at or after it.  The JAX package's
decoders start them at the next boundary strictly after it: one byte late
when the flush ends on a boundary.

The pictures of tests/enc_cases.py pcm_frames, encoded with PCM by the
port's encoder at three sizes and QPs, end the flushes after their PCM
CUs' pcm_flags at bit offsets 0 to 5 within a byte (recorded at each PCM
CU through a spy on CabacEncoder.pcm_payload, which byte-aligns the bit
writer).  Every picture decodes to the encoder's reconstruction with its
hash SEI OK through four routes: the Python parse with the numpy
reconstruction, the native parse, decode_batch(device="cpu") and the
port's libHMDec C ABI (libhmdec.so through tests/libhmdec_abi.py).
"""
import numpy as np
import pytest

import libhm_tpu_torch.encoder.encoder as TE
from libhm_tpu_torch.encoder import cabac_enc as CE
from libhm_tpu_torch.hostdec.decoder import Decoder
import libhmdec_abi as ABI
import torch_threads  # noqa: F401
from enc_cases import decode_statuses, pcm_frames

# name: (width, height, QP); the flush offsets of each picture are
# (4, 2, 4, 0), (4, 1, 5, 2) and (4, 0, 4, 1, 3, 1)
PICTURES = {"128x64_qp8": (128, 64, 8), "128x64_qp4": (128, 64, 4),
            "192x64_qp8": (192, 64, 8)}
ROUTES = ("python", "native", "decode_batch", "libhmdec")


def _encode(w, h, qp, offsets):
    """(stream, the encoder's reconstruction, the bit offset within its
    byte at which the flush after each PCM CU's pcm_flag ended), with
    `offsets` the list that the spy on pcm_payload fills."""
    offsets.clear()
    cfg = TE.EncoderConfig(w, h, gop="intra", qp=qp)
    cfg.pcm_enabled = True
    cfg.log2_min_ipcm, cfg.log2_max_ipcm = 3, 5
    enc = TE.IntraEncoder(cfg, device="cpu")
    data = enc.encode_stream(pcm_frames(w, h))
    return data, enc.stats[0][3], list(offsets)


@pytest.fixture(scope="module")
def pictures():
    offsets = []
    real = CE.CabacEncoder.pcm_payload

    def spy(self, bits):
        offsets.append(self.bw.nbits)
        return real(self, bits)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CE.CabacEncoder, "pcm_payload", spy)
        return {name: _encode(*args, offsets)
                for name, args in PICTURES.items()}


@pytest.fixture(scope="module")
def hmdec():
    return ABI.load(ABI.build())


def test_flush_offsets_include_a_byte_boundary(pictures):
    """One flush a PCM CU, as many as the decode finds PCM CUs; offset 0
    (no pcm_alignment_zero_bit) and at least three others occur."""
    seen = set()
    for name, (data, _, offsets) in pictures.items():
        dec = Decoder(parse="python", recon="numpy")
        dec.decode_annexb(data)
        pcm = dec.output_records[0].pic_syntax.pcm_list
        assert len(offsets) == len(pcm) // 3 > 0, name
        seen |= set(offsets)
    assert 0 in seen and len(seen - {0}) >= 3, seen


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", list(PICTURES))
def test_pcm_picture_decodes(pictures, name, route, request):
    data, recon, _ = pictures[name]
    if route == "libhmdec":
        pics, hash_ok = ABI.decode(request.getfixturevalue("hmdec"), data)
        assert hash_ok == 1
        planes = pics[0][1]
    elif route == "decode_batch":
        outs, statuses = decode_statuses(data, "cpu")
        assert statuses == ["OK"]
        planes = outs[0]
    else:
        dec = Decoder(parse=route, recon="numpy", check_sei_hash=True)
        planes = dec.decode_annexb(data)[0]
        assert [r.hash_status for r in dec.output_records] == ["OK"]
    assert len(planes) == 3
    for a, b in zip(planes, recon):
        np.testing.assert_array_equal(np.asarray(a), b)
