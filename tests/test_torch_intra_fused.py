"""K2 over every component of a DAG level in one launch.

On the CPU:
- the launch's table (batch_decode.intra_meta over every component, built
  by ops/intra.py fuse) on eight streams (tiles, slices, 4:2:2, 4:4:4,
  4:0:0, constrained intra, a 64x64 picture): units in ticket order
  (component, CTU row, picture), each unit's rows its component table's,
  the unit of each unit's row above (same picture and component) ticketed
  earlier and -1 exactly where there is none, F_CROSS only below such a
  unit, the work counts, and `chain` one (L, R) per (picture, component);
- the call over every component against one call per component (planes,
  and every count of ops/intra.py WORK), with "k2.components" and
  WORK["components"] counting the components that hold an intra block: 3
  at 4:2:0, 1 at 4:0:0 and where only luma has intra blocks;
- a decode makes one K2 call per DAG level with an intra block.

On the card (marked `cuda`; skips elsewhere, the check inside the
fixture):

    python -m pytest tests/test_torch_intra_fused.py -q -m cuda --noconftest

the one launch equals the three one-component launches and the plain
version, sample for sample, with every CTA the card holds and with one
(the ticket order alone orders the units): the I pictures of 4:2:0
goldens (8 and 10 bits, a random-access stream's I picture, constrained
intra in inter pictures), 4:2:2, 4:4:4, 4:0:0, luma and chroma at
unequal bit depths (8 / 12 and 12 / 8), and a 4096-wide 4:2:0 layout of
tests/intra_layouts.py, whose luma rows outgrow the lattice and whose
chroma rows fit it.

Integer arithmetic throughout: exact equality.
"""
import functools
import json
import os

import numpy as np
import pytest
import torch

import intra_layouts as LY
from libhm_tpu_torch.ops import intra as IK
from libhm_tpu_torch.parallel import batch_decode as TB
from libhm_tpu_torch.parallel import dag_decode as DD
from libhm_tpu_torch.utils import obs
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = json.load(open(os.path.join(ROOT, "testdata", "golden.json")))
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _stream_items(name):
    from libhm_tpu_torch.hostdec.decoder import Decoder
    data = open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(data)
    return dec.collected


def _ncomp(items):
    return 3 if items[0]["sps"].chroma_format_idc else 1


def _geometry(sps, comp, bd=None):
    """(is_luma, bd, W, H) and the padded plane shape's (Hp, Wp)."""
    sx = sps.chroma_shift_x() if comp else 0
    sy = sps.chroma_shift_y() if comp else 0
    if bd is None:
        bd = sps.bit_depth_chroma if comp else sps.bit_depth_luma
    return (dict(is_luma=comp == 0, bd=bd, W=sps.width >> sx,
                 H=sps.height >> sy),
            ((sps.pic_height_ctbs << sps.log2_ctb) >> sy,
             (sps.pic_width_ctbs << sps.log2_ctb) >> sx))


def _planes(items, comps, seed, device, depths=None):
    """Seeded planes and residuals of each component: ({c: plane},
    {c: res}, {c: geometry kwargs})."""
    rng = np.random.default_rng(seed)
    base, res, geo = {}, {}, {}
    for c in comps:
        g, (Hp, Wp) = _geometry(items[0]["sps"], c,
                                None if depths is None else depths[c > 0])
        shape = (len(items), Hp, Wp)
        base[c] = torch.from_numpy(rng.integers(0, 1 << g["bd"], shape)
                                   .astype(np.int32)).to(device)
        res[c] = torch.from_numpy(rng.integers(-64, 65, shape)
                                  .astype(np.int32)).to(device)
        geo[c] = g
    return base, res, geo


def _fused(items, base, res, geo, table, ctas=0):
    es = table["comps"]
    return IK.intra_wavefronts(
        [base[c].clone() for c in es], [res[c] for c in es], table,
        is_luma=[geo[c]["is_luma"] for c in es],
        bd=[geo[c]["bd"] for c in es], W=[geo[c]["W"] for c in es],
        H=[geo[c]["H"] for c in es], _ctas=ctas)


# ---------------------------------------------------------------------------
# CPU
UNIT_STREAMS = ("intra_main10_416x240", "tiles_832x480", "slices_416x240",
                "rext422_intra_416x240", "intra_rext444_416x240",
                "mono_intra_416x240", "cip_ra_160x96", "intra_64x64")


@pytest.mark.parametrize("name", UNIT_STREAMS)
def test_fused_units(name):
    items = _stream_items(name)
    ncomp = _ncomp(items)
    table = TB.intra_meta(items, tuple(range(ncomp)), CPU)
    parts = {c: TB.intra_table(items, c) for c in range(ncomp)}
    es = [c for c in range(ncomp) if parts[c] is not None]
    assert table["comps"] == es and len(es) == ncomp
    assert table["log2h"] == [parts[c][2] for c in es]
    rows = table["rows"]
    rs = table["row_start"].numpy()
    above = table["above"].numpy()
    U = len(above)
    assert len(rs) == U + 1 and rs[0] == 0 and rs[-1] == len(rows)
    assert (np.diff(rs) > 0).all()
    assert table["units"].numpy().tolist() == rs.tolist() + above.tolist()
    assert U == sum(len(parts[c][1]) - 1 for c in es)
    # ticket order (component, CTU row, picture), one unit each
    key = []
    for u in range(U):
        e = int(rows["comp"][rs[u]])
        key.append((es[e], int(rows["y"][rs[u]]) >> table["log2h"][e],
                    int(rows["b"][rs[u]])))
    assert key == sorted(set(key))
    # each unit: its component table's unit, field for field but the comp
    # byte
    mine = {}
    for c in es:
        crow, cs = parts[c][0], parts[c][1]
        for s, t in zip(cs[:-1], cs[1:]):
            mine[(c, int(crow["y"][s]) >> parts[c][2],
                  int(crow["b"][s]))] = crow[s:t]
    index = {k: u for u, k in enumerate(key)}
    for u, k in enumerate(key):
        got = rows[rs[u]:rs[u + 1]]
        assert (got["comp"] == es.index(k[0])).all()
        assert len(got) == len(mine[k]) and all(
            np.array_equal(got[f], mine[k][f]) for f in IK.BLOCK_DTYPE.names
            if f != "comp")
        # the row above: same picture and component, ticketed earlier
        up = index.get((k[0], k[1] - 1, k[2]), -1)
        assert above[u] == up and up < u
        cross = ((got["nf"] >> 4) & IK.F_CROSS) != 0
        assert not cross.any() or up >= 0
    assert table["work"] == IK.work(rows, rs)
    # one (L, R) per (picture, component), component by component
    assert table["chain"] == [lr for c in es for lr in
                              IK.chain(parts[c][0], parts[c][1],
                                       parts[c][2])]
    assert len(table["chain"]) == len({(it_b, b.comp)
                                       for it_b, it in enumerate(items)
                                       for b in it["pic"].intra_list})


def _luma_only():
    """One 4:2:0 picture whose intra blocks are all luma."""
    blocks = LY.random_layout(5, 256, 128, 10)
    return [LY.port_items(blocks, 256, 128, 10)]


@pytest.mark.parametrize("case", ["420", "422", "400", "luma_only"])
def test_fused_call_equals_one_call_a_component(case):
    if case == "luma_only":
        items = _luma_only()
        ncomp = 3
    else:
        items = _stream_items({"420": "intra_main10_416x240",
                               "422": "rext422_intra_416x240",
                               "400": "mono_intra_416x240"}[case])
        ncomp = _ncomp(items)
    want_comps = sorted({b.comp for it in items
                         for b in it["pic"].intra_list})
    base, res, geo = _planes(items, range(ncomp), 11, CPU)
    singles, work = {}, dict.fromkeys(IK.WORK, 0)
    for c in want_comps:
        before = dict(IK.WORK)
        singles[c] = IK.intra_wavefront(base[c].clone(), res[c],
                                        TB.intra_meta(items, c, CPU),
                                        **geo[c])
        for k in work:
            work[k] += IK.WORK[k] - before[k]
    table = TB.intra_meta(items, tuple(range(ncomp)), CPU)
    assert table["comps"] == want_comps
    obs.reset()
    before = dict(IK.WORK)
    with obs.span("outer"):
        got = _fused(items, base, res, geo, table)
    assert {k: IK.WORK[k] - before[k] for k in work} == work
    assert work["components"] == len(want_comps)
    counts = [s.n for s in obs.spans() if s.name == "k2.components"]
    assert counts == [len(want_comps)]
    for i, c in enumerate(want_comps):
        assert not torch.equal(got[i], base[c])
        assert torch.equal(got[i], singles[c]), c


@pytest.mark.parametrize("name", ["randomaccess_main10_416x240",
                                  "intra_main10_416x240"])
def test_one_call_a_level(name, monkeypatch):
    """_recon_levels makes one K2 call per DAG level with an intra block,
    over the components that hold one there."""
    items = _stream_items(name)
    calls = []
    real = IK.intra_wavefronts

    def spy(planes, res_planes, table, **kw):
        calls.append(list(table["comps"]))
        return real(planes, res_planes, table, **kw)
    monkeypatch.setattr(IK, "intra_wavefronts", spy)
    levels = DD.reference_levels(items)
    DD._recon_levels(items, [CPU], download=False)
    want = [sorted({b.comp for it in lv for b in it["pic"].intra_list})
            for lv in levels]
    assert calls == [w for w in want if w]
    assert any(len(w) == 3 for w in calls)


# ---------------------------------------------------------------------------
# the card
@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


# (stream or layout, pictures (None: all), bit depths (luma, chroma))
CUDA_CASES = {
    "main10_420": ("intra_main10_416x240", None, None),
    "main8_420": ("intra_416x240", None, None),
    "ra_i_picture": ("randomaccess_main10_416x240", [0], None),
    "cip_inter": ("cip_ra_160x96", None, None),
    "chroma422": ("rext422_intra_416x240", None, None),
    "chroma444": ("intra_rext444_416x240", None, None),
    "mono400": ("mono_intra_416x240", None, None),
    "depths_8_12": ("intra_main10_416x240", None, (8, 12)),
    "depths_12_8": ("main12_intra_416x240", None, (12, 8)),
    "layout_4096": ("layout", None, None),
}


def _cuda_items(case):
    name, pics, depths = CUDA_CASES[case]
    if name == "layout":
        item, _ = LY.port_items_420(60, 4096, 128, 10)
        return [item], depths
    items = _stream_items(name)
    return (items if pics is None else [items[b] for b in pics]), depths


@pytest.mark.cuda
@pytest.mark.parametrize("ctas", [0, 1])
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_fused_launch_on_gpu(gpu, case, ctas):
    items, depths = _cuda_items(case)
    ncomp = _ncomp(items)
    base, res, geo = _planes(items, range(ncomp), 3 + len(case), gpu,
                             depths)
    table = TB.intra_meta(items, tuple(range(ncomp)), gpu)
    es = table["comps"]
    assert es == list(range(ncomp))
    want, three = {}, {}
    for c in es:
        one = TB.intra_meta(items, c, gpu)
        want[c] = IK.intra_wavefront_plain(base[c].clone(), res[c], one,
                                           **geo[c])
        three[c] = IK.intra_wavefront(base[c].clone(), res[c], one,
                                      _ctas=ctas, **geo[c])
    obs.reset()
    n0 = IK._K2.launches
    runs = 5 if ctas == 0 else 1
    for _ in range(runs):
        got = _fused(items, base, res, geo, table, ctas)
        torch.cuda.synchronize()
        for i, c in enumerate(es):
            assert not torch.equal(want[c], base[c])
            assert torch.equal(three[c], want[c]), (c, "three launches")
            assert torch.equal(got[i], want[c]), \
                (c, int((got[i] != want[c]).sum()))
    assert IK._K2.launches == n0 + runs
    spans = obs.spans()
    assert [s.n for s in spans if s.name == "k2.components"] == \
        [ncomp] * runs
    lattice = [s.n for s in spans if s.name == "k2.lattice"][:ncomp]
    for c, wl in zip(es, lattice):
        Wc = base[c].shape[2]
        assert 0 < wl <= Wc and wl % 4 == 0
    if case == "layout_4096":
        # luma's rows outgrow the lattice, chroma's fit it whole
        assert lattice[0] < 4096 and lattice[1:] == [2048, 2048]
        plane = [s.n for s in spans if s.name == "k2.plane_blocks"][:ncomp]
        assert plane[0] > 0 and plane[1:] == [0, 0]
