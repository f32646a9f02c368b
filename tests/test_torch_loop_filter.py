"""The loop-filter level (K3 + K4 in one launch) on the CPU.

- device_filters.filter_level on CPU planes (the packed maps, one upload,
  then loop_filter_level_plain and the restore) against the JAX
  libhm_tpu.parallel.device_filters.filter_level on the same collect items
  and seeded pre-filter planes: a 2-picture level of randomaccess_416x240,
  tiles_nolfcross_512x128 (the multi-slice/tile SAO form) and two pictures
  of rext422_intra_416x240 (4:2:2);
- the tile emulation of the kernel: each T x T tile's window of apron 4,
  clipped to the plane as the kernel's clamped taps are, is filtered in a
  plane whose every other sample is junk, and only the tile's own samples
  are kept; stitched, the tiles equal the whole-plane composition (T 16
  and 32; 4:2:0, 4:2:2, 4:4:4 and 4:0:0; pictures cropped inside their
  padded planes; slices and tiles that do not filter across);
- the packed upload: one buffer per level, each map at a 16-byte offset
  in the kernel's read order, unpacked bit for bit;
- the kernel's descriptor: DESC_FIELDS in the order of the source's
  `Desc` struct.
"""
import json
import os
import re

import numpy as np
import pytest
import torch

from lf_cases import level_case
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = json.load(open(os.path.join(ROOT, "testdata", "golden.json")))
CPU = torch.device("cpu")


def _items(name):
    """The port's and the JAX package's collect items of one stream."""
    from libhm_tpu.hostdec.decoder import Decoder as JaxDecoder
    from libhm_tpu_torch.hostdec.decoder import Decoder
    data = open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()
    dec_t = Decoder(parse="native", recon="collect")
    dec_t.decode_annexb(data)
    dec_j = JaxDecoder(parse="native", recon="collect")
    dec_j.decode_annexb(data)
    return dec_t.collected, dec_j.collected


def _level(name):
    """(port items, JAX items) of the stream's first level with the most
    pictures, at most two."""
    from libhm_tpu_torch.parallel.dag_decode import reference_levels
    items_t, items_j = _items(name)
    index = {id(it["dp"]): i for i, it in enumerate(items_t)}
    level = max(reference_levels(items_t), key=len)[:2]
    return level, [items_j[index[id(it["dp"])]] for it in level]


@pytest.mark.parametrize("name", ["randomaccess_416x240",
                                  "tiles_nolfcross_512x128",
                                  "rext422_intra_416x240"])
def test_filter_level_equals_jax(name):
    import jax.numpy as jnp
    from libhm_tpu.parallel.device_filters import filter_level as jax_level
    from libhm_tpu_torch.ops import loopfilter as LF
    from libhm_tpu_torch.parallel import device_filters as DF
    from lf_cases import smooth_planes
    level, level_j = _level(name)
    assert len(level) == (1 if name.startswith("tiles") else 2)
    sps = level[0]["sps"]
    multi, restore, sao_on = DF.picture_filter_flags(level)
    assert sao_on and multi == name.startswith("tiles")
    assert sps.chroma_format_idc == (2 if name.startswith("rext") else 1)
    rng = np.random.default_rng(len(name))
    Hp = sps.pic_height_ctbs << sps.log2_ctb
    Wp = sps.pic_width_ctbs << sps.log2_ctb
    sx, sy = sps.chroma_shift_x(), sps.chroma_shift_y()
    planes = [smooth_planes(rng, (len(level), Hp >> (sy if c else 0),
                                  Wp >> (sx if c else 0)), sps.bit_depth_luma)
              for c in range(3)]
    n0 = LF._LF.launches
    got = DF.filter_level(level, [torch.from_numpy(p) for p in planes], sps,
                          CPU)
    assert LF._LF.launches == n0                  # the plain version on CPU
    want = jax_level(level_j, [jnp.asarray(p) for p in planes],
                     level_j[0]["sps"])
    for c in range(3):
        w = np.asarray(want[c])
        assert not np.array_equal(w, planes[c]), c
        assert np.array_equal(got[c].numpy(), w), c


def _emulate_tiles(planes, maps, kw, T, rng):
    """The level filtered tile by tile as the kernel does it: for tile
    (ty, tx) of each component, the T x T tile and its apron of 4, clipped
    to the plane, are kept and every other sample is junk; the plain
    composition runs on those planes and only the tile's samples are
    stitched into the result."""
    from libhm_tpu_torch.ops import loopfilter as LF
    out = [torch.full_like(p, -1) for p in planes]
    grid = [(-(-p.shape[1] // T), -(-p.shape[2] // T)) for p in planes]
    for ty in range(max(g[0] for g in grid)):
        for tx in range(max(g[1] for g in grid)):
            cut = []
            for p in planes:
                junk = torch.from_numpy(rng.integers(
                    0, 1 << kw["bd_l"], tuple(p.shape)).astype(np.int32))
                y0, x0 = ty * T, tx * T
                win = (slice(None), slice(max(y0 - 4, 0), y0 + T + 4),
                       slice(max(x0 - 4, 0), x0 + T + 4))
                junk[win] = p[win]
                cut.append(junk)
            res = LF.loop_filter_level_plain(cut, maps, **kw)
            for c, (gy, gx) in enumerate(grid):
                if ty < gy and tx < gx:
                    own = (slice(None), slice(ty * T, ty * T + T),
                           slice(tx * T, tx * T + T))
                    out[c][own] = res[c][own]
    return out


# (level_case arguments): luma 64x96 planes, 16x16 or 32x32 CTBs
EMULATION = {
    "420": dict(chroma=1, H=60, W=90),
    "422_multi": dict(chroma=2, H=64, W=88, log2_ctb=5, multi=True),
    "444_10bit": dict(chroma=3, H=56, W=96, bd_l=10),
    "400": dict(chroma=0, H=62, W=94, log2_ctb=5)}


@pytest.mark.parametrize("T", [16, 32])
@pytest.mark.parametrize("case", sorted(EMULATION))
def test_tile_emulation_equals_whole_plane(case, T):
    from libhm_tpu_torch.ops import loopfilter as LF
    rng = np.random.default_rng(T + sorted(EMULATION).index(case))
    planes, maps, kw = level_case(rng, **EMULATION[case])
    if kw["multi"]:
        assert not maps["lf4"].all() and maps["tm"].any()
    want = LF.loop_filter_level_plain(planes, maps, **kw)
    got = _emulate_tiles(planes, maps, kw, T, rng)
    for c in range(len(planes)):
        assert not torch.equal(want[c], planes[c]), c
        assert torch.equal(got[c], want[c]), c


def test_packed_maps_unpack_bit_for_bit(monkeypatch):
    """filter_level makes ONE upload per level, and every map of
    prepare_filter_maps (bool maps as uint8), the offset scales and
    loop_filter_across_tiles come back from it at 16-byte offsets in the
    kernel's read order."""
    from libhm_tpu_torch.parallel import device_filters as DF
    from libhm_tpu_torch.utils import xfer
    level = _items("tiles_nolfcross_512x128")[0][:2]
    maps = [DF.prepare_filter_maps(it["pic"], it["sps"], it["pps"],
                                   it["tile_map"]) for it in level]
    buf, layout = DF.pack_filter_maps(level, maps, 3)
    assert [layout[k][0] for k in layout] == sorted(
        layout[k][0] for k in layout)
    assert list(layout) == DF._map_order(layout)
    assert all(o % 16 == 0 for o, _, _ in layout.values())
    mb = DF.unpack_filter_maps(torch.from_numpy(buf), layout)
    assert set(mb) == set(maps[0]) | {"sao_scale_l", "sao_scale_c", "lft"}
    for k, v in mb.items():
        assert v.is_contiguous() and v.shape[0] == 3, k
        for b in range(3):
            if k in ("sao_scale_l", "sao_scale_c", "lft"):
                continue
            ref = maps[b][k] if b < 2 else np.zeros_like(maps[0][k])
            assert np.array_equal(v[b].numpy(), ref.astype(
                np.uint8 if ref.dtype == bool else ref.dtype)), (k, b)
    assert mb["lft"].tolist() == [
        int(it["pps"].loop_filter_across_tiles) for it in level] + [0]
    calls = []
    up = xfer.up
    monkeypatch.setattr(xfer, "up", lambda a, tag, dev: calls.append(tag) or
                        up(a, tag, dev))
    stacked = [torch.zeros((2, 128 >> (c > 0), 512 >> (c > 0)),
                           dtype=torch.int32) for c in range(3)]
    DF.filter_level(level, stacked, level[0]["sps"], CPU)
    assert calls == ["filter"]


def test_descriptor_matches_kernel_struct():
    """DESC_FIELDS lists the fields of csrc/loopfilter.cu's Desc struct
    (the three DescComp included) in order: the host array is copied
    into that struct."""
    from libhm_tpu_torch.ops import loopfilter as LF
    src = open(os.path.join(ROOT, "libhm_tpu_torch", "csrc",
                            "loopfilter.cu")).read()

    def fields(struct):
        body = re.search(r"struct %s \{(.*?)\};" % struct, src, re.S)[1]
        out = []
        for decl in body.split(";"):
            decl = re.sub(r"//[^\n]*", "", decl).strip()
            if not decl:
                continue
            typ, names = decl.split(None, 1) if not decl.startswith(
                "long long") else ("long long", decl[len("long long"):])
            for n in names.split(","):
                n = n.strip()
                m = re.fullmatch(r"(\w+)\[(\d)\]", n)
                if typ == "DescComp":
                    out += [f"{f}{c}" for c in range(int(m[2]))
                            for f in fields("DescComp")]
                elif m:
                    out += [f"{m[1]}_{'vh'[i]}" for i in range(int(m[2]))]
                else:
                    out.append(n)
        return out
    assert tuple(fields("Desc")) == LF.DESC_FIELDS
