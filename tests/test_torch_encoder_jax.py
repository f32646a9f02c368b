"""The port's encoder (libhm_tpu_torch.encoder) against the JAX package's
(libhm_tpu.encoder) on the CPU.

Both encoders take the same seeded pictures (tests/enc_cases.py) and the
same configuration.  The port's in-loop filter is the loop-filter
kernel's plain version (ops/loopfilter.py loop_filter_level on CPU
planes, device="cpu") where the JAX package's is hostdec/loopfilter_np;
each case must give the same bytes and the same filtered reconstruction
of every picture, and its stream must decode through the port's
decode_batch with every hash SEI OK, to the encoder's reconstructions.
The cases cover the native CTU compressor (intra, lowdelayP,
randomaccess) and each form of the filter path: several slices and two
tiles with the loop filter across slices off (SAO's multi form), SAO
without deblocking, PCM with pcm_loop_filter_disabled (the restore, K8),
4:2:2 at 10 bits on the Python path and the one-pass debug path.  The launches are counted: one
deblocking launch (V + H) and one SAO launch per picture; the port's
hostdec/loopfilter_np raises if the encoder calls it.
"""
import numpy as np
import pytest

import libhm_tpu.encoder.encoder as JE
import libhm_tpu_torch.encoder.encoder as TE
from libhm_tpu_torch.hostdec import loopfilter_np as NP
from libhm_tpu_torch.ops import loopfilter as LF
from libhm_tpu_torch.ops import pcm as PK
import torch_threads  # noqa: F401
from enc_cases import CASES, decode_statuses, encode

@pytest.mark.parametrize("name", list(CASES))
def test_encoder_equals_jax(name, monkeypatch):
    n, attrs, native, masks, changing = (CASES[name][k] for k in (
        2, 5, 6, 7, 8))
    want, jenc = encode(JE, name)

    launches, restores, compressed = [], [], []
    real_lf, real_restore = LF.loop_filter_level, PK.restore_unfiltered
    real_native = TE.IntraEncoder._native_compress

    def lf_spy(planes, maps, **kw):
        out = real_lf(planes, maps, **kw)
        launches.append((kw["mask"], kw["multi"], sum(
            int((o != p).sum()) for o, p in zip(out, planes))))
        return out

    def restore_spy(planes, pre, rmask, **kw):
        before = planes.clone()
        out = real_restore(planes, pre, rmask, **kw)
        restores.append(int((out != before).sum()))
        return out

    def native_spy(self, scan):
        compressed.append(1)
        return real_native(self, scan)
    monkeypatch.setattr(LF, "loop_filter_level", lf_spy)
    monkeypatch.setattr(PK, "restore_unfiltered", restore_spy)
    monkeypatch.setattr(TE.IntraEncoder, "_native_compress", native_spy)

    def refused(*a, **k):
        raise AssertionError("the encoder ran hostdec/loopfilter_np")
    for fn in ("deblock_picture", "sao_picture"):
        monkeypatch.setattr(NP, fn, refused)
    got, tenc = encode(TE, name, device="cpu")

    assert got == want
    assert [s[:3] for s in tenc.stats] == [s[:3] for s in jenc.stats]
    for sj, st in zip(jenc.stats, tenc.stats):
        for a, b in zip(sj[3], st[3]):
            np.testing.assert_array_equal(b, a)
    # the path and the launches: each picture's masks in order, SAO's
    # multi form exactly where the picture has several slices or tiles
    assert bool(compressed) == native
    assert [m for m, _, _ in launches] == masks * n
    multi = name == "slices_tiles"
    assert all(mu == (multi and m == LF.PASS_SAO)
               for m, mu, _ in launches)
    assert sorted({m for m, _, c in launches if c}) == sorted(changing)
    if attrs.get("pcm_filter_disabled"):
        assert len(restores) == 3 and sum(restores) > 0
        assert np.asarray(tenc.pic.pcm).any()
    else:
        assert not restores

    # the round trip: the port's decoder, every hash SEI OK, the pictures
    # equal to the encoder's reconstructions
    outs, statuses = decode_statuses(got, "cpu")
    assert statuses == ["OK"] * n
    recon = {s[2]: s[3] for s in tenc.stats}
    assert len(outs) == n
    for poc, pic in enumerate(outs):
        for a, b in zip(pic, recon[poc]):
            np.testing.assert_array_equal(np.asarray(a), b)
