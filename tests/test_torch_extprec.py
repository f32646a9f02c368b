"""Extended precision (RExt extended_precision_processing_flag) in the port:
K1's F_EXT rows on the CPU.

(a) residual_table_plain on seeded F_EXT tables (tests/ext_cases.py: every
    mode, bit depths 10, 12, 14 and 16, levels over [-2^M, 2^M - 1] with
    M = bd + 6) equals this file's own int64 numpy rendering of H.265
    8.6.2-8.6.4, 8.6.6 and 8.6.8, and rows without F_EXT in the same
    (int32) table equal themselves in an int16 table;
(b) the F_EXT rows equal the JAX _residual_fn at max_dyn = bd + 6 where
    JAX is exact: every dequantized, stage-1 and output value in int16;
(c) ROADMAP C6's case: a 4x4 DC dequantized to 40000 at 12 bits, M = 18;
(d) tools/make_extprec_stream.py's check on the committed streams: with
    and without the flag the native parse gives every TU the same
    coefficients;
(e) the small extended-precision stream (16-bit 4:4:4, M = 22) through
    decode_batch(device="cpu") and Decoder(parse="native", recon="torch",
    device="cpu") at its port_streams.json MD5, which Decoder(parse=
    "python", recon="numpy") (hostdec/refimpl.py under the flag) also
    gives, and which differs from the stream's without the flag.

Integer arithmetic throughout: every equality is exact.  Three JAX
compiles at most: (b) and (c) share one configuration.
"""
import hashlib
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from libhm_tpu_torch.hostdec.tables import DCT, DST4, INV_QUANT_SCALES
from libhm_tpu_torch.ops import transform as TK
from libhm_tpu_torch.parallel import batch_decode as TB

from ext_cases import ext_level
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTS = json.load(open(os.path.join(ROOT, "testdata", "port_streams.json")))
CPU = torch.device("cpu")
SMALL = "rext444_16b_intra_160x96_extprec"


def h265_residual(c, qp, n, bd, flags, m, rdpcm):
    """One TU's residual, int64 numpy, as H.265 8.6.2-8.6.4 and 8.6.8
    write it under extended_precision_processing_flag (M = max(15, bd +
    6)): c the [n, n] levels (row y, column x), m the [n, n] scaling
    factors of a scaled TU (16 otherwise)."""
    M = max(15, bd + 6)
    cmin, cmax = -(1 << M), (1 << M) - 1
    rot = (lambda a: a[::-1, ::-1]) if flags & TK.F_ROTATE else \
        (lambda a: a)
    c = c.astype(np.int64)
    if flags & TK.F_BYPASS:
        r = rot(c)
    else:
        # 8.6.3: d = Clip3(coeffMin, coeffMax, ((TransCoeffLevel * m *
        # levelScale << (qP / 6)) + (1 << (bdShift - 1))) >> bdShift)
        bd_shift = bd + (n.bit_length() - 1) + 10 - M
        d = np.clip(((c * m * INV_QUANT_SCALES[qp % 6]) << (qp // 6)) +
                    (1 << (bd_shift - 1)) >> bd_shift, cmin, cmax)
        bd_shift2 = max(20 - bd, 11)                       # 8.6.2
        if flags & TK.F_TSKIP:
            # 8.6.4.2: tsShift = Min(5, bdShift - 2) + Log2(nTbS)
            r = rot(d) << (min(5, bd_shift2 - 2) + n.bit_length() - 1)
        else:
            t = (DST4 if flags & TK.F_DST else DCT[n]).astype(np.int64)
            e = t.T @ d                                   # columns
            g = np.clip((e + 64) >> 7, cmin, cmax)
            r = g @ t                                     # rows
        r = (r + (1 << (bd_shift2 - 1))) >> bd_shift2
    if rdpcm:                                             # 8.6.8
        r = np.cumsum(r, axis=1 if rdpcm == 1 else 0)
    return r


def _render(rows, coeffs, mats, alphas, shape, res_l):
    """The planes that H.265 gives the table (8.6.6 for the CCP rows)."""
    out = np.zeros(shape, np.int64)
    for r, alpha in zip(rows, alphas):
        n, fl = 1 << int(r["log2n"]), int(r["flags"])
        o = int(r["off"])
        m = mats[n][r["midx"]].astype(np.int64) if fl & TK.F_SCALED else 16
        res = h265_residual(coeffs[o:o + n * n].reshape(n, n), int(r["qp"]),
                            n, int(r["bd"]), fl, m, int(r["rdpcm"]) & 3)
        b, y, x = int(r["b"]), int(r["y"]), int(r["x"])
        if alpha:
            res = res + ((alpha * res_l[b, y:y + n, x:x + n]
                          .astype(np.int64)) >> 3)
        out[b, y:y + n, x:x + n] = res
    return out


def _plain(case, shape, res_l=None):
    rows, coeffs, counts, flags, mats, _ = case
    table = TB.upload_tables([(rows, coeffs, counts, flags)], CPU)[0]
    planes = torch.zeros(shape, dtype=torch.int32)
    return TK.residual_table_plain(
        planes, table, {n: torch.from_numpy(m) for n, m in mats.items()},
        None if res_l is None else torch.from_numpy(res_l)).numpy()


@pytest.mark.parametrize("bd", [10, 12, 14, 16])
@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "ccp"])
def test_plain_equals_h265(bd, chroma):
    rng = np.random.default_rng(bd + 100 * chroma)
    shape = (2, 96, 160)
    case = ext_level(rng, bd, *shape, chroma=chroma)
    rows = case[0]
    flags = np.bitwise_or.reduce(rows["flags"])
    want_modes = TK.F_DST | TK.F_TSKIP | TK.F_BYPASS | TK.F_ROTATE | \
        TK.F_SCALED | TK.F_EXT | (TK.F_CCP if chroma else 0)
    assert flags == want_modes
    assert {1, 2} <= set(rows["rdpcm"] & 3)
    assert set(rows["log2n"]) == {2, 3, 4, 5}
    M = bd + 6
    res_l = rng.integers(-(1 << (M - 1)), 1 << (M - 1), shape) \
        .astype(np.int32) if chroma else None
    got = _plain(case, shape, res_l)
    want = _render(rows, case[1], case[4], case[5], shape, res_l)
    assert np.array_equal(got, want)
    if bd == 16:
        # residuals beyond int16, which the int16 clips would have cut
        assert np.abs(want).max() > 1 << 16


def test_plain_rows_unchanged_in_a_wide_table():
    """Rows without F_EXT in an int32 table (a level that mixes pictures
    with and without the flag) give what they give in an int16 table."""
    rng = np.random.default_rng(7)
    shape = (2, 96, 160)
    rows, coeffs, counts, flags, mats, alphas = ext_level(
        rng, 12, *shape, plain_share=0.5)
    plain = (rows["flags"] & TK.F_EXT) == 0
    assert plain.any() and not plain.all()
    mixed = _plain((rows, coeffs, counts, flags, mats, alphas), shape)
    keep = rows[plain]
    sizes = np.left_shift(1, 2 * keep["log2n"].astype(np.int64))
    narrow = np.concatenate([coeffs[o:o + s] for o, s in
                             zip(keep["off"], sizes)]).astype(np.int16)
    keep["off"] = np.cumsum(sizes) - sizes
    only = _plain((keep, narrow,
                   tuple(int((keep["log2n"] == s).sum()) for s in range(2, 6)),
                   int(np.bitwise_or.reduce(keep["flags"])), mats, alphas),
                  shape)
    mask = np.zeros(shape, bool)
    for r in keep:
        n = 1 << int(r["log2n"])
        mask[r["b"], r["y"]:r["y"] + n, r["x"]:r["x"] + n] = True
    assert np.array_equal(mixed[mask], only[mask])


def _jax_residual(c, qp, rdpcm, mat, *, n, use_dst, path, bd, rotate,
                  scaling):
    import jax.numpy as jnp
    from libhm_tpu.recon_tpu import _residual_fn
    fn = _residual_fn(n, use_dst, path, bd, bd + 6, rotate, scaling)
    return np.asarray(fn(jnp.asarray(c, jnp.int32), jnp.asarray(qp, jnp.int32),
                         jnp.asarray(rdpcm, jnp.int32),
                         jnp.asarray(mat, jnp.int32)))


def _ext_blocks(c, qp, rdpcm, mat, *, n, use_dst, tskip, bd, rotate):
    res = TK.residual_blocks(torch.from_numpy(c), torch.from_numpy(qp), n,
                             use_dst, tskip, bd, rotate=rotate,
                             mat=None if mat is None
                             else torch.from_numpy(mat), ext=True)
    return TK.inverse_rdpcm_batch(res, torch.from_numpy(rdpcm),
                                  clip=False).numpy()


# (n, use_dst, path, bd, rotate, scaling): the three JAX configurations
JAX_CASES = [(4, False, "dct", 12, False, False),
             (4, False, "tskip", 14, True, False),
             (16, False, "dct", 16, False, True)]


@pytest.mark.parametrize("n,use_dst,path,bd,rotate,scaling", JAX_CASES)
def test_plain_equals_jax_where_jax_is_exact(n, use_dst, path, bd, rotate,
                                             scaling):
    """Blocks whose every dequantized, stage-1 and output value fits in
    int16 (where JAX's int8-limb products are exact and its int16 clips
    cut nothing): the port's F_EXT residual equals JAX _residual_fn."""
    rng = np.random.default_rng(n + bd)
    P = 256
    c = rng.integers(-40, 41, (P, n, n)) * (rng.random((P, n, n)) < 0.3)
    qp = rng.integers(0, 40, P)
    rdpcm = rng.integers(0, 3, P) if path == "tskip" else np.zeros(P, int)
    mat = rng.integers(1, 64, (P, n, n)) if scaling else None
    fl = (TK.F_TSKIP if path == "tskip" else 0) | TK.F_ROTATE * rotate
    keep = []
    for i in range(P):
        m = mat[i] if scaling else 16
        want = h265_residual(c[i], int(qp[i]), n, bd, fl, m, int(rdpcm[i]))
        M = bd + 6
        bds = bd + (n.bit_length() - 1) + 10 - M
        d = np.clip(((c[i].astype(np.int64) * m * INV_QUANT_SCALES[qp[i] % 6])
                     << (qp[i] // 6)) + (1 << (bds - 1)) >> bds,
                    -(1 << M), (1 << M) - 1)
        g = (DCT[n].T.astype(np.int64) @ d + 64) >> 7
        if max(np.abs(d).max(), np.abs(g).max(),
               np.abs(want).max()) <= 32767:
            keep.append(i)
    assert len(keep) > P // 2
    c, qp, rdpcm = c[keep].astype(np.int32), qp[keep].astype(np.int32), \
        rdpcm[keep].astype(np.int32)
    mat = mat[keep].astype(np.int32) if scaling else None
    got = _ext_blocks(c, qp, rdpcm, mat, n=n, use_dst=use_dst,
                      tskip=path == "tskip", bd=bd, rotate=rotate)
    want = _jax_residual(c, qp, rdpcm, np.zeros_like(c) if mat is None
                         else mat, n=n, use_dst=use_dst, path=path, bd=bd,
                         rotate=rotate, scaling=scaling)
    assert got.any()
    assert np.array_equal(got, want)


def test_c6_dc_of_40000():
    """ROADMAP C6: a 4x4 DCT TU at 12 bits, M = 18, whose DC level 2500 at
    qp 4 dequantizes to 40000.  H.265: stage 1 gives 20000, the residual
    (64 * 20000 + 1024) >> 11 = 625 everywhere.  The port gives 625, the
    JAX function -399 (its int8 limbs hold int16 values only)."""
    c = np.zeros((1, 4, 4), np.int32)
    c[0, 0, 0] = 2500
    qp, rd = np.array([4], np.int32), np.zeros(1, np.int32)
    want = h265_residual(c[0], 4, 4, 12, 0, 16, 0)
    assert (want == 625).all()
    got = _ext_blocks(c, qp, rd, None, n=4, use_dst=False, tskip=False,
                      bd=12, rotate=False)
    assert (got == 625).all()
    jax = _jax_residual(c, qp, rd, np.zeros_like(c), n=4, use_dst=False,
                        path="dct", bd=12, rotate=False, scaling=False)
    assert (jax == -399).all()


def _tool():
    spec = importlib.util.spec_from_file_location(
        "make_extprec_stream", os.path.join(ROOT, "tools",
                                            "make_extprec_stream.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _data(name):
    return open(os.path.join(ROOT, "testdata", PORTS[name]["bitstream"]),
                "rb").read()


@pytest.mark.parametrize("name", [n for n in PORTS if n.endswith("_extprec")])
def test_stream_tool_check(name):
    """The committed stream is its source with the flag set in the SPS,
    and every TU parses alike with and without it."""
    tool = _tool()
    src = _data(name[:-len("_extprec")])
    ext = _data(name)
    assert tool.with_extended_precision(src) == ext
    assert tool.same_coefficients(src, ext) > 1000


def _md5(pics):
    return hashlib.md5(b"".join(p.tobytes() for pic in pics
                                for p in pic)).hexdigest()


def test_small_stream_decodes():
    from libhm_tpu_torch.hostdec.decoder import Decoder
    from libhm_tpu_torch.parallel.dag_decode import decode_batch, \
        decode_streams
    data, want = _data(SMALL), PORTS[SMALL]["decoded_yuv_md5"]
    TK._K1_EXT.launches = 0
    assert _md5(decode_batch(data, device=CPU)) == want
    assert [_md5(pics) for pics in decode_streams([data, data],
                                                  device=CPU)] == [want] * 2
    assert _md5(Decoder(parse="native", recon="torch",
                        device=CPU).decode_annexb(data)) == want
    assert _md5(Decoder(parse="python", recon="numpy")
                .decode_annexb(data)) == want
    # the plain version ran: nothing launched
    assert TK._K1_EXT.launches == 0
    assert want != PORTS[SMALL[:-len("_extprec")]]["decoded_yuv_md5"]
