"""Cross-component prediction as K1's epilogue, on the CPU.

- the CCP alpha rides in the rdpcm byte of a TU_DTYPE row (F_CCP rows)
  and comes back out of `_fields`, the RDPCM direction beside it;
- residual_table_plain on seeded 4:4:4 chroma tables (tests/ccp_cases.py:
  alpha rows of every size and sign, CCP-only rows with zero
  coefficients, bypass and transform skip with RDPCM, rotation, TUs past
  the plane's right and bottom edges, values driven into the int16 clip)
  equals the same table without alphas followed by JAX _ccp_fn(n), the
  program it replaces;
- residual_tables puts each TU's alpha in its row on
  ccp444_lowdelay_160x96, and the level's residual build makes one upload
  and no CCP pass of its own.

Integer arithmetic throughout: equality is exact.
"""
import json
import os

import numpy as np
import pytest
import torch

from ccp_cases import ALPHAS, SIZES, ccp_level
from libhm_tpu_torch.ops import transform as TK
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = json.load(open(os.path.join(ROOT, "testdata", "golden.json")))
CPU = torch.device("cpu")


def _table(rows, coeffs, counts, alpha=None):
    """A CPU TuTable of numpy rows, with `alpha` written in (F_CCP rows)."""
    rows = rows.copy()
    if alpha is not None:
        rows["rdpcm"] |= TK.ccp_bits(alpha)
        rows["flags"] |= np.where(alpha != 0, TK.F_CCP, 0).astype(np.uint8)
    return TK.TuTable(torch.from_numpy(rows.view(np.uint8).reshape(-1, 16)),
                      torch.from_numpy(coeffs), counts,
                      int(np.bitwise_or.reduce(rows["flags"], initial=0)))


def test_alpha_bits_round_trip():
    """Every alpha and RDPCM direction through ccp_bits, TU_DTYPE and
    _fields; the other fields unchanged; rows without F_CCP have none."""
    alpha = np.array([0] + list(ALPHAS) * 3, np.int64)
    rows = np.zeros(len(alpha), TK.TU_DTYPE)
    rows["rdpcm"] = np.arange(len(alpha)) % 3
    rows["b"] = np.arange(len(alpha)) - 3
    rows["qp"] = -12
    rows["midx"] = 200
    rows["bd"] = 12
    rows["log2n"] = 2
    f = TK._fields(_table(rows, np.zeros(16 * len(rows), np.int16),
                          (len(rows), 0, 0, 0), alpha).rows)
    assert f["alpha"].tolist() == alpha.tolist()
    assert f["rdpcm"].tolist() == rows["rdpcm"].tolist()
    assert f["b"].tolist() == rows["b"].tolist()
    assert set(f["qp"].tolist()) == {-12} and set(f["bd"].tolist()) == {12}
    assert set(f["midx"].tolist()) == {200}
    assert ((f["flags"] & TK.F_CCP) != 0).tolist() == (alpha != 0).tolist()
    # the bits alone, without the flag, are no CCP
    bare = rows.copy()
    bare["rdpcm"] |= TK.ccp_bits(alpha)
    f = TK._fields(torch.from_numpy(bare.view(np.uint8).reshape(-1, 16)))
    assert not f["alpha"].any()
    with pytest.raises(ValueError, match="alpha"):
        TK.ccp_bits([3])


@pytest.mark.parametrize("bd", [8, 10])
def test_ccp_epilogue_plain_equals_jax(bd):
    """residual_table_plain with alpha rows == the table without them and
    then JAX _ccp_fn per TU size."""
    import jax.numpy as jnp
    from libhm_tpu.parallel.batch_decode import _ccp_fn
    B, H, W = 2, 72, 104
    lv = ccp_level(np.random.default_rng(30 + bd), TK.TU_DTYPE, B, H, W,
                   share=0.5, bd=bd)
    rows, alpha = lv["rows"], lv["alpha"]
    on = alpha != 0
    for n in SIZES:                       # the cases the level must hold
        for sign in (-1, 1):
            assert (on & (rows["log2n"] == n.bit_length() - 1) &
                    (np.sign(alpha) == sign)).any(), (n, sign)
    zero = np.asarray([not lv["coeffs"][o:o + (1 << (2 * l))].any()
                       for o, l in zip(rows["off"], rows["log2n"])])
    assert (on & zero).any()
    bypass = (rows["flags"] & TK.F_BYPASS) != 0
    assert (on & bypass & (rows["rdpcm"] > 0)).any()
    assert (on & (rows["flags"] == TK.F_TSKIP | TK.F_ROTATE)).any()
    assert (on & (rows["y"] + (1 << rows["log2n"]) > H)).any()
    assert (on & (rows["x"] + (1 << rows["log2n"]) > W)).any()
    res_l = torch.from_numpy(lv["res_l"])
    got = TK.residual_table_plain(
        torch.zeros((B, H, W), dtype=torch.int32),
        _table(rows, lv["coeffs"], lv["counts"], alpha), res_l=res_l)
    before = TK.residual_table_plain(
        torch.zeros((B, H, W), dtype=torch.int32),
        _table(rows, lv["coeffs"], lv["counts"])).numpy()
    want = jnp.asarray(before)
    tus = lv["tus"]
    for n in SIZES:
        t = tus[tus[:, 3] == n]
        want = _ccp_fn(n)(want, jnp.asarray(lv["res_l"]),
                          jnp.asarray(t[:, 0]), jnp.asarray(t[:, 1]),
                          jnp.asarray(t[:, 2]), jnp.asarray(t[:, 4]))
    want = np.asarray(want)
    assert np.array_equal(got.numpy(), want)
    assert not np.array_equal(want, before)
    # the clip acts: some CCP sums leave the int16 range
    amap = np.zeros((B, H, W), np.int64)
    for b, y, x, n, a in tus:
        amap[b, y:y + n, x:x + n] = a
    raw = before + ((amap * lv["res_l"]) >> 3)
    assert ((raw > 32767) | (raw < -32768)).any()


def test_ccp_rows_need_luma_residual():
    lv = ccp_level(np.random.default_rng(3), TK.TU_DTYPE, 1, 32, 64,
                   share=1.0)
    table = _table(lv["rows"], lv["coeffs"], lv["counts"], lv["alpha"])
    planes = torch.zeros((1, 32, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="res_l"):
        TK.residual_table(planes, table)
    with pytest.raises(ValueError, match="res_l"):
        TK.residual_table(planes, table,
                          res_l=torch.zeros((1, 16, 32), dtype=torch.int32))
    # a table without alpha rows takes none
    TK.residual_table(planes, _table(lv["rows"], lv["coeffs"], lv["counts"]))


def test_ccp_apply_refuses_cuda_tensors_by_name():
    """On the card CCP has no wrapper of its own (K1's epilogue); the
    check is made before any device is touched."""
    from libhm_tpu_torch.ops import ccp as CK

    class Fake:
        is_cuda = True
    with pytest.raises(ValueError, match="epilogue of K1"):
        CK.ccp_apply(Fake(), None, None)


def test_residual_tables_carry_alpha():
    """Every 4:4:4 chroma TU of ccp444_lowdelay_160x96 (CCP-only TUs with
    zero coefficients too) has its cross_comp_alpha in its row, F_CCP
    exactly where it is nonzero; one upload builds the level's residual,
    equal to the JAX planes."""
    from libhm_tpu.hostdec.decoder import Decoder as JaxDecoder
    from libhm_tpu.parallel import batch_decode as JB
    from libhm_tpu_torch.hostdec.decoder import Decoder
    from libhm_tpu_torch.parallel import batch_decode as TB
    from libhm_tpu_torch.utils import xfer
    data = open(os.path.join(ROOT, "testdata",
                             GOLD["ccp444_lowdelay_160x96"]["bitstream"]),
                "rb").read()
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(data)
    items = dec.collected[:3]
    tables, _ = TB.residual_tables(items)
    zero_ccp = 0
    for c, (rows, _, _, flags) in enumerate(tables):
        want = [(b, tu.y, tu.x, tu.cross_comp_alpha if c else 0)
                for n in SIZES for b, it in enumerate(items)
                for tu in it["pic"].tu_list if tu.comp == c and tu.w == n]
        zero_ccp += sum(1 for b, it in enumerate(items)
                        for tu in it["pic"].tu_list if tu.comp == c and c
                        and tu.cross_comp_alpha and not tu.coeffs.any())
        f = TK._fields(torch.from_numpy(rows.view(np.uint8).reshape(-1, 16)))
        got = list(zip(f["b"].tolist(), f["y"].tolist(), f["x"].tolist(),
                       f["alpha"].tolist()))
        assert got == want
        assert ((f["flags"] & TK.F_CCP) != 0).tolist() == \
            [a != 0 for *_, a in want]
        assert bool(flags & TK.F_CCP) == (c > 0)
    assert zero_ccp > 0
    xfer.reset()
    got = TB._residual_planes_batch_device(items, len(items), CPU)
    assert xfer.UPLOADS == {"coeff": 1}
    jdec = JaxDecoder(parse="native", recon="collect")
    jdec.decode_annexb(data)
    want = JB._residual_planes_batch_device(jdec.collected[:3], 3)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
