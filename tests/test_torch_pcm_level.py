"""K9 (PCM samples of a DAG level, one launch) on the CPU.

- pcm_level_plain over one packed table of every component equals the
  JAX package's per-block scatters (libhm_tpu/parallel/dag_decode.py
  _recon_levels: `.at[b, y:y+h, x:x+w].set(blk << shift)`) at 4:2:0, 4:2:2
  (w x 2w chroma blocks), 4:4:4 and 4:0:0, with other luma and chroma
  shifts;
- pcm_pack's buffer: rows sorted by area as the counts say, each block's
  samples at a multiple of 16 samples, the sample part on a 16-byte
  boundary, the fields as written; bad block shapes refused;
- rows of pictures outside [0, Bp) are skipped, samples past the plane
  dropped;
- pcm_port_416x240 through decode_batch and through the per-picture
  decoder: its MD5, with one `pcm` upload for its one PCM level.

Integer arithmetic throughout: equality is exact.
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from libhm_tpu_torch.ops import pcm as PK
from pcm_cases import FORMATS, pcm_blocks, plane_shapes
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTS = json.load(open(os.path.join(ROOT, "testdata", "port_streams.json")))


def _level(rng, fmt, B=2, Hp=64, Wp=96):
    """About half of the level's 32x32 cells with a PCM CU and its chroma
    blocks, luma shift 2 and chroma shift 3; (blocks, plane shapes)."""
    return pcm_blocks(rng, fmt, B, Hp, Wp), plane_shapes(fmt, B, Hp, Wp)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_pcm_level_plain_equals_jax(fmt):
    import jax.numpy as jnp
    blocks, shapes = _level(np.random.default_rng(50 + fmt), fmt)
    if fmt == 2:
        assert any(c and h == 2 * w for c, _, _, _, w, h, _, _ in blocks)
    if fmt:
        assert len({s for c, *_, s, _ in blocks}) == 2
    want = [jnp.zeros(s, jnp.int32) for s in shapes]
    for c, b, x, y, w, h, shift, s in blocks:
        blk = np.asarray(s, np.int32).reshape(h, w) << shift
        want[c] = want[c].at[b, y:y + h, x:x + w].set(jnp.asarray(blk))
    buf, counts = PK.pcm_pack(blocks)
    planes = [torch.zeros(s, dtype=torch.int32) for s in shapes]
    PK.pcm_level(planes, PK.pcm_table(torch.from_numpy(buf), counts))
    for g, w in zip(planes, want):
        assert np.asarray(w).any()
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_pcm_pack_layout():
    blocks, _ = _level(np.random.default_rng(7), 2)
    buf, counts = PK.pcm_pack(blocks)
    N = len(blocks)
    rows = buf[:16 * N].view(PK.PCM_DTYPE)
    area = rows["log2w"].astype(int) + rows["log2h"]
    assert list(area) == sorted(area)
    assert counts == tuple(int((area == a).sum()) for a in PK.LOG2_AREAS)
    assert sum(counts) == N and buf.dtype == np.uint8
    assert (rows["off"] % 16 == 0).all()
    samples = buf[16 * N:].view(np.int16)
    assert len(samples) == sum(w * h for _, _, _, _, w, h, _, _ in blocks)
    # stable: blocks of one area in their given order
    order = sorted(range(N), key=lambda k: (blocks[k][4] * blocks[k][5], k))
    f = PK._pcm_fields(torch.from_numpy(buf[:16 * N].copy()).view(-1, 16))
    for j, k in enumerate(order):
        c, b, x, y, w, h, shift, s = blocks[k]
        assert (f["comp"][j], f["b"][j], f["x"][j], f["y"][j],
                1 << f["log2w"][j], 1 << f["log2h"][j], f["shift"][j]) == \
            (c, b, x, y, w, h, shift)
        o = int(rows["off"][j])
        assert np.array_equal(samples[o:o + w * h], s.reshape(-1))
    table = PK.pcm_table(torch.from_numpy(buf), counts)
    assert table.rows.shape == (N, 16) and table.samples.dtype == torch.int16
    for bad in ((0, 0, 0, 0, 2, 4, 0, np.zeros(8)),
                (0, 0, 0, 0, 12, 4, 0, np.zeros(48)),
                (0, 0, 0, 0, 64, 64, 0, np.zeros(4096)),
                (0, 0, 0, 0, 8, 8, 0, np.zeros(60))):
        with pytest.raises(ValueError, match="pcm_pack"):
            PK.pcm_pack([bad])


def test_pcm_level_skips_and_drops():
    """A row of a padding picture is skipped, a block past the plane's
    right and bottom edges keeps its samples inside, a component without
    a plane is skipped."""
    rng = np.random.default_rng(8)
    s = [rng.integers(1, 256, (h, w)) for w, h in ((8, 8), (16, 16),
                                                  (8, 16), (4, 4))]
    blocks = [(0, 2, 0, 0, 8, 8, 1, s[0]),           # picture 2 of 2
              (0, 1, 40, 20, 16, 16, 2, s[1]),       # past 48 x 28
              (1, 0, 4, 4, 8, 16, 0, s[2]),
              (2, 0, 0, 0, 4, 4, 0, s[3])]           # no plane 2
    buf, counts = PK.pcm_pack(blocks)
    planes = [torch.zeros((2, 28, 48), dtype=torch.int32),
              torch.zeros((2, 28, 24), dtype=torch.int32)]
    PK.pcm_level(planes, PK.pcm_table(torch.from_numpy(buf), counts))
    want = [np.zeros((2, 28, 48), np.int64), np.zeros((2, 28, 24), np.int64)]
    want[0][1, 20:28, 40:48] = s[1][:8, :8] << 2
    want[1][0, 4:20, 4:12] = s[2]
    for g, w in zip(planes, want):
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("path", ["decode_batch", "per_picture"])
def test_pcm_port_one_upload(path):
    from libhm_tpu_torch.hostdec.decoder import Decoder
    from libhm_tpu_torch.parallel import dag_decode as DD
    from libhm_tpu_torch.utils import xfer
    name = "pcm_port_416x240"
    data = open(os.path.join(ROOT, "testdata", PORTS[name]["bitstream"]),
                "rb").read()
    xfer.reset()
    if path == "decode_batch":
        outs = DD.decode_batch(data, device="cpu")
    else:
        dec = Decoder(parse="native", recon="torch", device="cpu")
        dec.decode_annexb(data)
        outs = dec.outputs
    md5 = hashlib.md5(b"".join(p.tobytes() for pic in outs for p in pic))
    assert md5.hexdigest() == PORTS[name]["decoded_yuv_md5"]
    assert xfer.UPLOADS["pcm"] == 1
