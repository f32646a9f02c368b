"""PCM with pcm_loop_filter_disabled in the port's encoder (ROADMAP C3).

The encoder's IPCM decision codes a CU normally and re-codes it as PCM
when the raw samples are cheaper (encoder.py encode_cu).  That trial marks
pic.pcm; when the RDO quadtree then prefers the split, it rolls the CU
back through _save_cu_state / _restore_cu_state.  The port rolls pic.pcm
back with the other CU maps (IntraEncoder._CU_MAPS); the JAX package's
encoder does not, so a rejected trial leaves its mark, the
pcm_loop_filter_disabled restore (K8's plain version here) puts deblocked
samples of non-PCM CUs back to their unfiltered values, and the hash SEI
that the encoder writes disagrees with what every decoder reconstructs.
On those pictures the port's bytes differ from the JAX encoder's: the
port follows the stream's own MD5, as in ROADMAP C11 and C12 (North star:
the MD5 wins).  A cfg's PCMFilterDisableFlag reaches pcm_filter_disabled
through the port's options.py, where the JAX package's config build drops
it.

The ROADMAP's first repro, 0/255 noise over the whole picture at QP 16,
shows nothing: every CU of it is PCM, so no trial is rolled back.  The
pictures of tests/enc_cases.py C3_CASES are those on which the fault
shows.  The cfg-driven cases run enc_app on the "mixed" C3 picture at
QP 4, 8, 10 and 16, and on the whole-picture 0/255 noise at QP 4, 8 and
10 (coded all as PCM, so with a pcm flush in every CU).  Everything runs
on the CPU (device="cpu")."""

import numpy as np
import pytest

import libhm_tpu.encoder.encoder as JE
import libhm_tpu_torch.encoder.encoder as TE
from libhm_tpu_torch.apps import enc_app
from libhm_tpu_torch.encoder.options import HmConfig, parse_cfg_files
from libhm_tpu_torch.hostdec.decoder import Decoder
from libhm_tpu_torch.ops import pcm as PK
import torch_threads  # noqa: F401
from enc_cases import (C3_CASES, c3_config, decode_statuses, noise_picture,
                       pcm_frames)


def numpy_decode(data):
    """(pictures, hash SEI statuses, pcm maps) of the port's
    Decoder(parse="python", recon="numpy") with the hash check."""
    dec = Decoder(parse="python", recon="numpy", check_sei_hash=True)
    outs = dec.decode_annexb(data)
    recs = dec.output_records
    return (outs, [r.hash_status for r in recs],
            [np.asarray(r.pic_syntax.pcm) for r in recs])


@pytest.mark.parametrize("name", list(C3_CASES))
def test_rejected_pcm_trial_leaves_no_mark(name, monkeypatch):
    """The port's stream decodes with its hash SEI OK in the numpy decoder
    and in decode_batch, to the encoder's reconstruction, with the PCM CUs
    that the encoder marked; the JAX encoder's bytes differ and fail
    their own hash SEI."""
    kind, seed, qp = C3_CASES[name]
    pics = noise_picture(128, 64, kind, seed)
    restored = []
    real = PK.restore_unfiltered

    def spy(planes, pre, rmask, **kw):
        before = planes.clone()
        out = real(planes, pre, rmask, **kw)
        restored.append(int((out != before).sum()))
        return out
    monkeypatch.setattr(PK, "restore_unfiltered", spy)
    enc = TE.IntraEncoder(c3_config(TE, qp), device="cpu")
    data = enc.encode_stream(pics)
    recon = enc.stats[0][3]
    assert len(restored) == 3            # K8 once per component
    if kind == "mixed":                  # the binary half stays PCM
        assert np.asarray(enc.pic.pcm)[:, :16].all() and sum(restored) > 0

    outs, statuses, pcm = numpy_decode(data)
    assert statuses == ["OK"]
    np.testing.assert_array_equal(pcm[0], np.asarray(enc.pic.pcm) != 0)
    for a, b in zip(outs[0], recon):
        np.testing.assert_array_equal(np.asarray(a), b)
    outs, statuses = decode_statuses(data, "cpu")
    assert statuses == ["OK"]
    for a, b in zip(outs[0], recon):
        np.testing.assert_array_equal(np.asarray(a), b)

    # the JAX encoder keeps the rejected trial's marks: more marks than
    # the PCM CUs it coded, other bytes, and a hash SEI that its own
    # stream fails
    jenc = JE.IntraEncoder(c3_config(JE, qp))
    jdata = jenc.encode_stream(pics)
    assert jdata != data
    assert np.asarray(jenc.pic.pcm).sum() > np.asarray(enc.pic.pcm).sum()
    assert numpy_decode(jdata)[1] == ["MISMATCH"]


def _cfg(tmp_path, qp, filter_disable):
    path = tmp_path / "pcm.cfg"
    path.write_text(
        "SourceWidth             : 128\n"
        "SourceHeight            : 64\n"
        "InputBitDepth           : 8\n"
        "FramesToBeEncoded       : 1\n"
        "IntraPeriod             : 1\n"
        "GOPSize                 : 1\n"
        f"QP                      : {qp}\n"
        "PCMEnabledFlag          : 1\n"
        "PCMLog2MinSize          : 3\n"
        "PCMLog2MaxSize          : 5\n"
        f"PCMFilterDisableFlag    : {filter_disable}\n"
        "SEIDecodedPictureHash   : 1\n")
    return str(path)


@pytest.mark.parametrize("flag", [0, 1])
def test_cfg_sets_pcm_filter_disabled(flag, tmp_path):
    cfg = HmConfig(parse_cfg_files([_cfg(tmp_path, 16, flag)])) \
        .to_encoder_config()
    assert cfg.pcm_enabled and cfg.pcm_filter_disabled is bool(flag)


@pytest.mark.parametrize("kind,qp", [("mixed", 4), ("mixed", 8),
                                     ("mixed", 10), ("mixed", 16),
                                     ("binary", 4), ("binary", 8),
                                     ("binary", 10)])
def test_cfg_driven_pcm_encode(kind, qp, tmp_path, monkeypatch):
    """enc_app -c with PCMFilterDisableFlag: 1 on the "mixed" C3 picture
    and on 0/255 noise over the whole picture (seed 0): the flag reaches
    the encoder and the SPS, and the picture decodes with its hash SEI OK
    to the recon file that enc_app writes."""
    y, u, v = noise_picture(128, 64, kind, 0)[0]
    src, out, rec = (str(tmp_path / n) for n in ("src.yuv", "out.bin",
                                                 "rec.yuv"))
    open(src, "wb").write(y.tobytes() + u.tobytes() + v.tobytes())
    seen = []
    real = TE.IntraEncoder.__init__

    def spy(self, cfg, *a, **k):
        seen.append(cfg.pcm_filter_disabled)
        real(self, cfg, *a, **k)
    monkeypatch.setattr(TE.IntraEncoder, "__init__", spy)
    assert enc_app.main(["-c", _cfg(tmp_path, qp, 1), "-i", src, "-b", out,
                         "-o", rec, "--device", "cpu"]) == 0
    assert seen == [True]
    data = open(out, "rb").read()
    dec = Decoder(parse="python", recon="numpy", check_sei_hash=True)
    outs = dec.decode_annexb(data)
    assert [r.hash_status for r in dec.output_records] == ["OK"]
    sps = next(iter(dec.sps_map.values()))
    assert sps.pcm_enabled and sps.pcm_loop_filter_disabled
    joined = b"".join(np.asarray(p).astype(np.uint8).tobytes()
                      for p in outs[0])
    assert joined == open(rec, "rb").read()


def test_pcm_after_byte_aligned_flush():
    """pcm_frames at QP 8 without pcm_loop_filter_disabled: the flush after
    its last PCM CU's pcm_flag ends on a byte boundary, so the stream has
    no pcm_alignment_zero_bit there, and the samples start right after the
    flush (ROADMAP C13: the JAX package's decoders skip one byte more; the
    port's start at the next byte boundary at or after the position)."""
    cfg = TE.EncoderConfig(128, 64, gop="intra", qp=8)
    cfg.pcm_enabled = True
    cfg.log2_min_ipcm, cfg.log2_max_ipcm = 3, 5
    enc = TE.IntraEncoder(cfg, device="cpu")
    data = enc.encode_stream(pcm_frames(128, 64))
    outs, statuses, _ = numpy_decode(data)
    assert statuses == ["OK"]
    for a, b in zip(outs[0], enc.stats[0][3]):
        np.testing.assert_array_equal(np.asarray(a), b)
