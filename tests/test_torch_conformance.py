"""Where the port follows H.265 and the JAX package does not, on the CPU.

Cross-component prediction at unequal bit depths (ROADMAP C4).  H.265
8.6.6 adds (alpha * ((rY << BitDepthC) >> BitDepthY)) >> 3 to the chroma
residual; the JAX _ccp_fn adds (alpha * rY) >> 3, the same only at equal
depths.
- K1's plain version with CCP rows (residual_table_plain on the seeded
  4:4:4 chroma tables of tests/ccp_cases.py, luma residuals over the whole
  int16 range, every alpha of +-1, +-2, +-4, +-8), ccp_apply and the numpy
  host backend's _apply_cross_component equal the int64 rendering of 8.6.6
  below at eight (BitDepthY, BitDepthC) pairs, and JAX _ccp_fn at the
  equal ones;
- intra_rext444_nosao (10-bit 4:4:4, CCP on, SAO off) with its SPS
  rewritten to luma 10 / chroma 9 and to luma 9 / chroma 10 (tests/
  sps_edit.py) parses to the same TUs, CCP ones among them, and
  decode_batch(device="cpu") gives the planes of the numpy and the native
  host backends.  The hash SEI hashes the 10-bit decode, so it is not
  checked.

Weighted prediction under high_precision_offsets_enabled_flag (ROADMAP
C10).  H.265 7.4.7.3 sets WpOffsetBdShiftY/C to 0 under the flag (else
BitDepth - 8) and widens the offsets' range to +-2^(BitDepth - 1); the
JAX package always shifts.
- a hand-built pred_weight_table() parses to the luma offsets and to the
  chroma offsets that 7.4.7.3 derives with wpOffsetHalfRangeC, with the
  flag on and off at 8-16 bits;
- K6's plain version (mc_weighted_plain) on seeded full-sample blocks,
  uni and bi, luma and 4:2:0 chroma, given the offsets shifted by the
  port's wp_offset_shift, equals the int64 rendering of 8.5.3.3.4.3 below
  at 8, 10, 12 and 16 bits with the flag on and off, and JAX
  _mc_scatter_fn with it off;
- two 8-bit streams of the port's encoder with weighted prediction (P
  slices, and B slices with bi-prediction; no SAO, whose offsets' cMax
  depends on the bit depth) with their SPS rewritten to 8, 10, 12 and 16
  bits, with and without the flag: decode_batch's K6 tables hold each
  PU's parsed offsets shifted as 7.4.7.3 says, and its planes equal the
  Python parse's and the native parse's numpy decode, and the native
  backend's up to 12 bits (it holds samples in int16, ROADMAP C8).

Integer arithmetic throughout: equality is exact.
"""
import json
import os
import types

import numpy as np
import pytest
import torch

import libhm_tpu_torch.encoder.encoder as TE
import sps_edit as E
import torch_threads  # noqa: F401
from ccp_cases import ALPHAS, ccp_level
from enc_cases import frames
from libhm_tpu_torch.encoder.cabac_enc import BitWriter
from libhm_tpu_torch.hostdec import params as P
from libhm_tpu_torch.hostdec.bitstream import BitReader
from libhm_tpu_torch.hostdec.decoder import Decoder
from libhm_tpu_torch.hostdec.motion import wp_offset_shift
from libhm_tpu_torch.hostdec.picture import TransformUnit
from libhm_tpu_torch.hostdec.recon_np import PictureRecon
from libhm_tpu_torch.ops import ccp as CK
from libhm_tpu_torch.ops import interp as IK
from libhm_tpu_torch.ops import transform as TK
from libhm_tpu_torch.parallel import dag_decode as DD

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = json.load(open(os.path.join(ROOT, "testdata", "golden.json")))
DEPTH_PAIRS = [(8, 8), (10, 10), (8, 10), (10, 8), (8, 12), (12, 8),
               (16, 8), (8, 16)]
I16 = (-32768, 32767)


def _same(a, b):
    return len(a) == len(b) and all(
        np.array_equal(np.asarray(p), np.asarray(q))
        for x, y in zip(a, b) for p, q in zip(x, y))


# ---------------------------------------------------------------------------
# C4: cross-component prediction, H.265 8.6.6

def ccp_8_6_6(res_c, res_l, tus, bdy, bdc, clip=True):
    """int64 rendering of H.265 8.6.6 on [B, H, W] planes: each TU (b, y,
    x, n, alpha) adds (alpha * ((rY << BitDepthC) >> BitDepthY)) >> 3,
    clipped to int16 as the port's non-extended rows are (clip)."""
    out = res_c.astype(np.int64)
    for b, y, x, n, a in tus:
        ry = res_l[b, y:y + n, x:x + n].astype(np.int64)
        v = out[b, y:y + n, x:x + n] + ((int(a) * ((ry << bdc) >> bdy)) >> 3)
        out[b, y:y + n, x:x + n] = np.clip(v, *I16) if clip else v
    return out


def _table(rows, coeffs, counts, alpha=None):
    """A CPU TuTable of numpy rows, with `alpha` written in (F_CCP rows)."""
    rows = rows.copy()
    if alpha is not None:
        rows["rdpcm"] |= TK.ccp_bits(alpha)
        rows["flags"] |= np.where(alpha != 0, TK.F_CCP, 0).astype(np.uint8)
    return TK.TuTable(torch.from_numpy(rows.view(np.uint8).reshape(-1, 16)),
                      torch.from_numpy(coeffs), counts,
                      int(np.bitwise_or.reduce(rows["flags"], initial=0)))


def _numpy_backend(res_c, res_l, tus, bdy, bdc):
    """hostdec/recon_np.py PictureRecon._apply_cross_component on the
    TUs of `tus` (one picture), each as a luma and a chroma TU."""
    tu_list, residuals = [], []
    for _, y, x, n, a in tus:
        for comp, plane, alpha in ((0, res_l[0], 0), (1, res_c[0], int(a))):
            tu_list.append(TransformUnit(comp, x, y, n, n, None, 0, 0, 0,
                                         0, 0, alpha))
            residuals.append(plane[y:y + n, x:x + n].astype(np.int32))
    recon = types.SimpleNamespace(
        pic=types.SimpleNamespace(tu_list=tu_list),
        sps=types.SimpleNamespace(chroma_format_idc=3, bit_depth_luma=bdy,
                                  bit_depth_chroma=bdc,
                                  extended_precision=0))
    PictureRecon._apply_cross_component(recon, residuals)
    return residuals[1::2]


@pytest.mark.parametrize("bdy,bdc", DEPTH_PAIRS,
                         ids=[f"{y}-{c}" for y, c in DEPTH_PAIRS])
def test_ccp_follows_8_6_6(bdy, bdc):
    """K1's plain version with CCP rows, ccp_apply and the numpy host
    backend equal the rendering of 8.6.6; at equal depths, JAX _ccp_fn."""
    B, H, W = 2, 72, 104
    rng = np.random.default_rng(100 * bdy + bdc)
    lv = ccp_level(rng, TK.TU_DTYPE, B, H, W, share=0.5, bd=bdc)
    rows, alpha, tus, res_l = lv["rows"], lv["alpha"], lv["tus"], lv["res_l"]
    assert set(tus[:, 4].tolist()) == set(ALPHAS)
    zeros = lambda: torch.zeros((B, H, W), dtype=torch.int32)  # noqa: E731
    before = TK.residual_table_plain(
        zeros(), _table(rows, lv["coeffs"], lv["counts"])).numpy()
    want = ccp_8_6_6(before, res_l, tus, bdy, bdc)
    got = TK.residual_table_plain(
        zeros(), _table(rows, lv["coeffs"], lv["counts"], alpha),
        res_l=torch.from_numpy(res_l), ccp_bd=(bdy, bdc))
    np.testing.assert_array_equal(got.numpy(), want)

    # chroma residuals over the whole int16 range, through ccp_apply
    res_c = rng.integers(-32768, 32768, (B, H, W)).astype(np.int32)
    got = CK.ccp_apply(torch.from_numpy(res_c.copy()),
                       torch.from_numpy(res_l), torch.from_numpy(tus),
                       ccp_bd=(bdy, bdc))
    want = ccp_8_6_6(res_c, res_l, tus, bdy, bdc)
    np.testing.assert_array_equal(got.numpy(), want)
    # the int16 clip acts
    raw = ccp_8_6_6(res_c, res_l, tus, bdy, bdc, clip=False)
    assert ((raw < I16[0]) | (raw > I16[1])).any()

    # the numpy host backend, on picture 0's TUs inside the plane
    inside = tus[(tus[:, 0] == 0) & (tus[:, 1] + tus[:, 3] <= H) &
                 (tus[:, 2] + tus[:, 3] <= W)]
    for (_, y, x, n, _), blk in zip(
            inside, _numpy_backend(res_c, res_l, inside, bdy, bdc)):
        np.testing.assert_array_equal(blk, want[0, y:y + n, x:x + n])

    if bdy != bdc:
        # the scale matters: the reference's formula gives other values
        assert not np.array_equal(want, ccp_8_6_6(res_c, res_l, tus, 8, 8))
        return
    import jax.numpy as jnp
    from libhm_tpu.parallel.batch_decode import _ccp_fn
    ref = jnp.asarray(res_c)
    for n in (4, 8, 16, 32):
        t = tus[tus[:, 3] == n]
        ref = _ccp_fn(n)(ref, jnp.asarray(res_l), jnp.asarray(t[:, 0]),
                         jnp.asarray(t[:, 1]), jnp.asarray(t[:, 2]),
                         jnp.asarray(t[:, 4]))
    np.testing.assert_array_equal(np.asarray(ref), want)


def _tus(data):
    """(comp, x, y, w, alpha, coefficients) of every TU of the native
    parse of `data`, picture by picture."""
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(data)
    return [[(t.comp, t.x, t.y, t.w, t.cross_comp_alpha,
              np.asarray(t.coeffs).tobytes()) for t in it["pic"].tu_list]
            for it in dec.collected]


@pytest.mark.parametrize("bdy,bdc", [(10, 9), (9, 10)],
                         ids=["10-9", "9-10"])
def test_ccp_unequal_depth_stream(bdy, bdc):
    """intra_rext444_nosao at luma bdy / chroma bdc: the same TUs, CCP
    ones among them; decode_batch gives the host backends' planes."""
    data = open(os.path.join(ROOT, "testdata",
                             GOLD["intra_rext444_nosao"]["bitstream"]),
                "rb").read()
    derived = E.rewrite_sps(data, lambda r: E.set_bit_depths(r, bdy, bdc))
    assert len(derived) == len(data)        # ue(v) of 1 and 2: 3 bits
    tus = _tus(derived)
    assert tus == _tus(data)
    assert sum(1 for pic in tus for t in pic if t[0] and t[4]) > 0
    got = DD.decode_batch(derived, device="cpu")
    assert len(got) == GOLD["intra_rext444_nosao"]["frames"]
    for recon in ("numpy", "native"):
        want = Decoder(parse="native", recon=recon).decode_annexb(derived)
        assert _same(got, want), recon


# ---------------------------------------------------------------------------
# C10: weighted prediction, H.265 7.4.7.3 and 8.5.3.3.4.3

def _half_range(bd, flag):
    """wpOffsetHalfRangeY/C (H.265 7.4.7.3)."""
    return 1 << (bd - 1 if flag else 7)


@pytest.mark.parametrize("flag", [0, 1])
@pytest.mark.parametrize("bd", [8, 10, 12, 16])
def test_pred_weight_table_offsets(bd, flag):
    """A hand-built pred_weight_table() of a B slice (two references in
    list 0, one in list 1): the luma offsets as coded, the chroma offsets
    Clip3(-half, half - 1, (half - ((half * w) >> denom)) + delta)."""
    rng = np.random.default_rng(bd + 100 * flag)
    half = _half_range(bd, flag)
    denom_l, denom_c = 5, 6
    nref = [2, 1]
    bw = BitWriter()
    bw.ue(denom_l)
    bw.se(denom_c - denom_l)
    want_l, want_c = [[], []], [[], []]
    for l in range(2):
        for _ in range(nref[l]):
            bw.put(1)                       # luma_weight_lX_flag
        for _ in range(nref[l]):
            bw.put(1)                       # chroma_weight_lX_flag
        for _ in range(nref[l]):
            dw = int(rng.integers(-128, 128))
            o = int(rng.integers(-half, half))
            bw.se(dw)
            bw.se(o)
            want_l[l].append((1, (1 << denom_l) + dw, o))
            pairs = []
            for _ in range(2):
                dwc = int(rng.integers(-128, 128))
                dco = int(rng.integers(-4 * half, 4 * half))
                bw.se(dwc)
                bw.se(dco)
                w = (1 << denom_c) + dwc
                o = min(max(half - ((half * w) >> denom_c) + dco, -half),
                        half - 1)
                pairs.append((w, o))
            want_c[l].append((1, pairs[0], pairs[1]))
    bw.byte_align_one()
    sh = P.SliceHeader(slice_type=P.B_SLICE, num_ref_idx=nref)
    sps = P.SPS(chroma_format_idc=1, bit_depth_luma=bd, bit_depth_chroma=bd,
                high_precision_offsets=flag)
    P._parse_pred_weight_table(BitReader(bw.data()), sh, sps)
    assert (sh.wp_log2_denom_luma, sh.wp_log2_denom_chroma) == \
        (denom_l, denom_c)
    for l in range(2):
        assert sh.wp_luma[l] == want_l[l]
        assert sh.wp_chroma[l] == want_c[l]


def wp_8_5_3_3_4_3(refs, blk, sx, sy, bd, flag, denom):
    """int64 rendering of H.265 8.5.3.3.4.3 for full-sample blocks of
    `blk` (BLK_FIELDS rows with unshifted offsets): predSamplesLX =
    refPicLX << shift1, shift1 = Max(2, 14 - bitDepth), log2WD = denom +
    shift1, o = offset << WpOffsetBdShift (0 under the flag, else
    bitDepth - 8); one list: Clip3(0, max, ((pred * w + 2^(log2WD - 1)) >>
    log2WD) + o); both: Clip3(0, max, (pred0 * w0 + pred1 * w1 + ((o0 + o1
    + 1) << log2WD)) >> (log2WD + 1)).  Returns {(b, y, x): sample}."""
    _, H, W = refs.shape
    shift1 = max(2, 14 - bd)
    log2wd = denom + shift1
    oshift = 0 if flag else bd - 8
    fbx, fby = (2 + sx, 2 + sy) if sx or sy else (2, 2)
    bh, bw = 4 >> sy, 4 >> sx
    out = {}
    for r in blk.astype(np.int64):
        b, x0, y0, d = r[0], r[1], r[2], r[3]
        pred, w, o = [], [], []
        for l in range(2):
            mx, my = r[4 + 2 * l] >> fbx, r[5 + 2 * l] >> fby
            ys = np.clip(y0 + my + np.arange(bh), 0, H - 1)
            xs = np.clip(x0 + mx + np.arange(bw), 0, W - 1)
            pred.append(refs[r[8 + l]][np.ix_(ys, xs)].astype(np.int64)
                        << shift1)
            w.append(int(r[10 + l]))
            o.append(int(r[12 + l]) << oshift)
        if d == 3:
            v = (pred[0] * w[0] + pred[1] * w[1] +
                 ((o[0] + o[1] + 1) << log2wd)) >> (log2wd + 1)
        else:
            l = 0 if d == 1 else 1
            v = ((pred[l] * w[l] + (1 << (log2wd - 1))) >> log2wd) + o[l]
        v = np.clip(v, 0, (1 << bd) - 1)
        for i in range(bh):
            for j in range(bw):
                out[(b, y0 + i, x0 + j)] = v[i, j]
    return out


def _wp_blocks(rng, bd, flag, sx, sy, B, H, W, R):
    """Full-sample blocks on every 4x4 luma cell of B pictures (uni from
    list 0 or 1, or bi), weights over [-128, 255], unshifted offsets over
    the flag's range; the extremes in the first rows."""
    half = _half_range(bd, flag)
    cy, cx = np.mgrid[0:H >> sy:4 >> sy, 0:W >> sx:4 >> sx]
    n = cy.size
    blk = np.zeros((B * n, len(IK.BLK_FIELDS)), np.int64)
    blk[:, 0] = np.repeat(np.arange(B), n)
    blk[:, 1] = np.tile(cx.ravel(), B)
    blk[:, 2] = np.tile(cy.ravel(), B)
    blk[:, 3] = rng.integers(1, 4, B * n)
    fb = (2 + sx, 2 + sy) if sx or sy else (2, 2)
    for l in range(2):
        blk[:, 4 + 2 * l] = rng.integers(-6, 7, B * n) << fb[0]
        blk[:, 5 + 2 * l] = rng.integers(-6, 7, B * n) << fb[1]
    blk[:, 8:10] = rng.integers(0, R, (B * n, 2))
    blk[:, 10:12] = rng.integers(-128, 256, (B * n, 2))
    blk[:, 12:14] = rng.integers(-half, half, (B * n, 2))
    blk[:4, 10:12] = [[255, 255], [255, 255], [-128, -128], [255, -128]]
    blk[:4, 12:14] = [[half - 1, half - 1], [-half, -half],
                      [half - 1, -half], [-half, half - 1]]
    blk[:4, 3] = [3, 1, 2, 3]
    return blk


@pytest.mark.parametrize("flag", [0, 1])
@pytest.mark.parametrize("bd", [8, 10, 12, 16])
def test_wp_follows_8_5_3_3_4_3(bd, flag):
    """mc_weighted_plain with the offsets shifted by wp_offset_shift
    equals the rendering of 8.5.3.3.4.3 (denominators 0, 3 and 7); with
    the flag off, JAX _mc_scatter_fn."""
    rng = np.random.default_rng(10 * bd + flag)
    B, H, W, R = 2, 32, 48, 3
    sps = types.SimpleNamespace(high_precision_offsets=flag)
    for is_luma, sx, sy in ((True, 0, 0), (False, 1, 1)):
        h, w = H >> sy, W >> sx
        refs = rng.integers(0, 1 << bd, (R, h, w)).astype(np.int32)
        refs[0, :4, :4] = (1 << bd) - 1
        blk = _wp_blocks(rng, bd, flag, sx, sy, B, H, W, R)
        table = blk.copy()
        table[:, 12:14] <<= wp_offset_shift(sps, bd)
        table = table.astype(np.int32)
        res = np.zeros((B, h, w), np.int32)
        for denom in (0, 3, 7):
            got = IK.mc_weighted_plain(
                torch.zeros((B, h, w), dtype=torch.int32),
                torch.from_numpy(res), torch.from_numpy(refs),
                torch.from_numpy(table), is_luma=is_luma, sx=sx, sy=sy,
                bd=bd, wp=True, denom=denom, W=w, H=h).numpy()
            want = wp_8_5_3_3_4_3(refs, blk, sx, sy, bd, flag, denom)
            keys = np.array(list(want))
            np.testing.assert_array_equal(
                got[keys[:, 0], keys[:, 1], keys[:, 2]],
                np.array(list(want.values())), err_msg=f"{is_luma} {denom}")
            if flag:
                continue
            from libhm_tpu.parallel import dag_decode as JD
            import jax.numpy as jnp
            taps, fbx, fby = IK._filter_args(is_luma, sx, sy)
            fn = JD._mc_scatter_fn(4 >> sx, 4 >> sy, taps, fbx, fby, bd, "wp")
            ref = np.asarray(fn(
                jnp.zeros((B, h, w), jnp.int32), jnp.asarray(res),
                jnp.asarray(refs), jnp.asarray(table[:, 8]),
                jnp.asarray(table[:, 9]), jnp.asarray(table[:, 0]),
                jnp.asarray(table[:, 1]), jnp.asarray(table[:, 2]),
                jnp.asarray(table[:, 4:8].reshape(-1, 2, 2)),
                jnp.asarray(table[:, 3]), jnp.asarray(table[:, 10:12]),
                jnp.asarray(table[:, 12:14]), denom, w, h))
            np.testing.assert_array_equal(got, ref)


def _fade(w, h, n):
    """n 8-bit pictures of tests/enc_cases.py frames fading in luma and
    shifting in chroma, so that the encoder's WP analysis picks weights
    and offsets."""
    out = []
    for t, (y, u, v) in enumerate(frames(w, h, n)):
        out.append(((y * (1 - 0.12 * t) + 6 * t).astype(np.uint8),
                    np.clip(u.astype(int) + 5 * t, 0, 255).astype(np.uint8),
                    np.clip(v.astype(int) - 4 * t, 0, 255).astype(np.uint8)))
    return out


@pytest.fixture(scope="module")
def wp_streams():
    """{"P": lowdelayP with weighted_pred, "B": randomaccess with
    weighted_bipred}: 64x48, 3 pictures, QP 27, no SAO."""
    out = {}
    for kind, gop, attr in (("P", "lowdelayP", "weighted_pred"),
                            ("B", "randomaccess", "weighted_bipred")):
        cfg = TE.EncoderConfig(64, 48, gop=gop, qp=27)
        setattr(cfg, attr, True)
        cfg.sao = 0
        out[kind] = TE.IntraEncoder(cfg, device="cpu").encode_stream(
            _fade(64, 48, 3))
    return out


@pytest.mark.parametrize("flag", [0, 1])
@pytest.mark.parametrize("bd", [8, 10, 12, 16])
@pytest.mark.parametrize("kind", ["P", "B"])
def test_wp_stream_offsets(wp_streams, kind, bd, flag, monkeypatch):
    """The stream at bit depth bd, with or without the flag: K6's tables
    hold each PU's offsets << WpOffsetBdShift; decode_batch's planes equal
    the host backends'."""
    data = E.rewrite_sps(wp_streams[kind],
                         lambda r: E.set_bit_depths(r, bd, bd))
    if flag:
        data = E.rewrite_sps(
            data, lambda r: E.set_range_flag(r, "high_precision_offsets"))
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(data)
    want = {c: set() for c in range(3)}
    dirs = set()
    for it in dec.collected:
        assert it["sps"].high_precision_offsets == flag
        for pu in it["pic"].inter_list:
            assert pu.wp is not None
            dirs.add(pu.inter_dir)
            for c in range(3):
                want[c].add(tuple(pu.wp["w"][l][c] for l in range(2)) +
                            tuple(pu.wp["o"][l][c] << (0 if flag else bd - 8)
                                  for l in range(2)))
    assert dirs >= ({1} if kind == "P" else {2, 3})
    assert any(o for c in range(3) for t in want[c] for o in t[2:])

    calls = []
    real = IK.mc_weighted

    def spy(stacked, res, refs, blk, **kw):
        calls.append((kw["is_luma"],
                      {tuple(r) for r in blk[:, 10:14].tolist()}))
        return real(stacked, res, refs, blk, **kw)
    monkeypatch.setattr(IK, "mc_weighted", spy)
    got = DD.decode_batch(data, device="cpu")
    monkeypatch.setattr(IK, "mc_weighted", real)
    # a level launches its k luma groups, then k for Cb and k for Cr
    seen = {c: set() for c in range(3)}
    i = 0
    while i < len(calls):
        k = 0
        while i + k < len(calls) and calls[i + k][0]:
            k += 1
        assert k > 0
        for c in range(3):
            for _, rows in calls[i + c * k:i + (c + 1) * k]:
                seen[c] |= rows
        i += 3 * k
    assert seen == want

    backends = [("python", "numpy"), ("native", "numpy")]
    if bd <= 12:
        backends.append(("native", "native"))
    for parse, recon in backends:
        ref = Decoder(parse=parse, recon=recon).decode_annexb(data)
        assert _same(got, ref), (parse, recon)
