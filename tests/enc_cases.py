"""Seeded encoder inputs shared by the port's encoder tests and
chip_smoke.py's encoder phase.

- `recipe_source(cfg)`: the source YUV bytes that the generator in the
  header of a testdata/*.cfg of the repo's high-bit-depth streams writes
  (rext444_16b_intra_160x96, main14_intra_160x96, the random-access
  streams of 13-16 bits), run as written;
- `frames(...)`: moving synthetic 4:2:0 / 4:2:2 pictures (the content of
  tests/test_enc_native.py) as encode_stream takes them; `pcm_frames`:
  one picture that the encoder codes partly as PCM; `noise_picture`,
  `C3_CASES` and `c3_config`: the pictures on which a rejected PCM trial
  left its marks (ROADMAP C3);
- `recipe_input(cfg)`: the EncoderConfig and pictures of a cfg's recipe
  as the port's enc_app reads them; `RA16` and `RA16_MD5`: the stream
  that the port's encoder writes for mono16_ra_160x96's recipe;
- `edge_frames(...)`: `frames` with a moving texture of 0/max blocks on
  the right half of the luma, whose qpel intermediates pass 2^15 from 13
  bits on;
- `decode_statuses`: the port's decode_batch of a stream with every
  checked hash SEI's status;
- `CASES` and `encode`: the small encoder configurations that the port
  is held on, each with what its in-loop filter must launch.
"""
import contextlib
import io
import os
import re
import textwrap

import numpy as np

from libhm_tpu_torch.ops import loopfilter as LF


def recipe_source(cfg_path):
    """(bytes of the source YUV, its frame count) of a cfg's recipe: the
    indented comment lines of its header before the encoder's command,
    run as Python with numpy as np, write src.yuv; the count is the cfg's
    FramesToBeEncoded."""
    text = open(cfg_path).read()
    code = []
    for line in text.splitlines(keepends=True):
        if line.startswith("#   python -m"):
            break
        if line.startswith("#   "):
            code.append(line[1:])
    buf = io.BytesIO()

    @contextlib.contextmanager
    def sink(name, mode):
        assert name == "src.yuv" and mode == "wb", (name, mode)
        yield buf
    exec(textwrap.dedent("".join(code)), {"np": np, "open": sink})
    n = int(re.search(r"^FramesToBeEncoded\s*:\s*(\d+)", text,
                      re.M).group(1))
    return buf.getvalue(), n


# The port's encoder on mono16_ra_160x96's recipe (Monochrome 16, random
# access, search range 64) on the CPU, with IntraEncoder._motion_search_rect
# and _bi_window_search on their Python path: 1217 bytes of this MD5, made
# once by `enc_app.main(["-c", "testdata/mono16_ra_160x96.cfg", "-i",
# "src.yuv", "-b", "out.bin", "--device", "cpu"])` on `recipe_source`'s
# src.yuv, with each of the two methods wrapped to set
# IntraEncoder._ENC_NATIVE to (None,) for the length of its call (the
# encoder's other native kernels on).  The native search's int32 form
# writes the same bytes.  testdata/mono16_ra_160x96.bin (1318 bytes) was
# made before, with the int16 form that narrowed 16-bit samples (ROADMAP
# C14).
RA16 = "mono16_ra_160x96"
RA16_MD5 = "621399c6a11a1698e47dc7dda2aa3e64"


def recipe_input(cfg_path):
    """(EncoderConfig, pictures) of a cfg whose recipe writes its source
    at the internal bit depth, read as the port's enc_app reads them."""
    from libhm_tpu_torch.encoder.options import HmConfig, parse_cfg_files
    hm = HmConfig(parse_cfg_files([cfg_path]))
    cfg = hm.to_encoder_config()
    assert hm.get("input_bit_depth", cfg.bit_depth) == cfg.bit_depth
    src, n = recipe_source(cfg_path)
    w, h = cfg.width, cfg.height
    shapes = [(h, w)]
    if cfg.chroma_format_idc:
        sx = 1 if cfg.chroma_format_idc in (1, 2) else 0
        sy = 1 if cfg.chroma_format_idc == 1 else 0
        shapes += [(h >> sy, w >> sx)] * 2
    dt = np.uint8 if cfg.bit_depth <= 8 else np.dtype("<u2")
    raw = np.frombuffer(src, dt).astype(
        np.uint8 if cfg.bit_depth <= 8 else np.uint16)
    pics, at = [], 0
    for _ in range(n):
        pic = []
        for sh in shapes:
            pic.append(raw[at:at + sh[0] * sh[1]].reshape(sh))
            at += sh[0] * sh[1]
        pics.append(tuple(pic))
    return cfg, pics


def edge_frames(w, h, n, *, bd, seed=7):
    """`frames(w, h, n, bd=bd)` with the right half of each luma plane
    replaced by seeded noise, each sample 0 or (1 << bd) - 1, moved 1.25
    samples right and 0.75 down a picture by H.265's 8-tap luma filters
    (one rounding, clipped): its best matches lie at fractional MVs, where
    the first filter stage, (sum c * s) >> Min(4, bd - 8), reaches up to
    88 * ((1 << bd) - 1) >> 4, past 2^15 from 13 bits on."""
    taps = np.array([[0, 0, 0, 64, 0, 0, 0, 0],
                     [-1, 4, -10, 58, 17, -5, 1, 0],
                     [-1, 4, -11, 40, 40, -11, 4, -1],
                     [0, 1, -5, 17, 58, -10, 4, -1]], np.int64)
    rng = np.random.default_rng(seed)
    m = 8 + 2 * n                     # margin of the texture, in samples
    tex = rng.integers(0, 2, (h + 2 * m, w // 2 + 2 * m)) * ((1 << bd) - 1)
    out = []
    for t, (y, u, v) in enumerate(frames(w, h, n, bd=bd, seed=seed)):
        # the texture at (row - 0.75 t, column - 1.25 t), in quarters
        iy, fy, ix, fx = -3 * t >> 2, -3 * t & 3, -5 * t >> 2, -5 * t & 3
        blk = tex[m + iy - 3:m + iy + h + 4, m + ix - 3:m + ix + w // 2 + 4]
        r = sum(taps[fx][k] * blk[:, k:k + w // 2] for k in range(8))
        r = sum(taps[fy][k] * r[k:k + h] for k in range(8))
        y = y.copy()
        y[:, w // 2:] = np.clip((r + 2048) >> 12, 0, (1 << bd) - 1)
        out.append((y, u, v))
    return out


def frames(w, h, n, *, bd=8, chroma=1, seed=7, shift=2):
    """n (Y, Cb, Cr) pictures of a ramp moving `shift` samples a picture
    to the right, with seeded noise, at bit depth bd (4:2:0 or 4:2:2)."""
    rng = np.random.default_rng(seed)
    dt = np.uint8 if bd <= 8 else np.uint16
    up = 1 << (bd - 8)
    base = (np.linspace(0, 200, w, dtype=np.int32)[None, :] +
            np.linspace(0, 40, h, dtype=np.int32)[:, None])
    ch = h // 2 if chroma == 1 else h
    out = []
    for t in range(n):
        y = np.clip(np.roll(base, shift * t, axis=1) +
                    rng.integers(-8, 9, (h, w)), 0, 255) * up
        u = np.clip(128 + base[::2 if chroma == 1 else 1, ::2] // 4, 0,
                    255)[:ch] * up
        v = np.full((ch, w // 2), 90 * up)
        out.append((y.astype(dt), u.astype(dt), v.astype(dt)))
    return out


def pcm_frames(w, h):
    """One 4:2:0 picture whose 32x32 luma blocks alternate between the
    moving ramp and seeded salt-and-pepper noise (0 or 255): at QP 16 the
    encoder codes the noise blocks as PCM, and deblocking changes samples
    of theirs that the restore gives back."""
    rng = np.random.default_rng(11)
    y, u, v = [p.copy() for p in frames(w, h, 1)[0]]
    for by in range(0, h, 32):
        for bx in range(0, w, 32):
            if (by + bx) // 32 % 2 == 0:
                y[by:by + 32, bx:bx + 32] = rng.integers(0, 2, (32, 32)) * 255
                for p in (u, v):
                    p[by // 2:by // 2 + 16, bx // 2:bx // 2 + 16] = \
                        rng.integers(0, 2, (16, 16)) * 255
    return [(y, u, v)]


def noise_picture(w, h, kind, seed):
    """One 4:2:0 picture of seeded noise from numpy's default_rng(seed),
    drawn per plane (luma, then Cb, then Cr): "binary" each sample 0 or
    255, "uniform" each 0..255, "mixed" uniform with its left half drawn
    again as binary."""
    rng = np.random.default_rng(seed)
    planes = []
    for ph, pw in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
        if kind == "binary":
            p = rng.integers(0, 2, (ph, pw)) * 255
        else:
            p = rng.integers(0, 256, (ph, pw))
            if kind == "mixed":
                p[:, :pw // 2] = rng.integers(0, 2, (ph, pw // 2)) * 255
        planes.append(p.astype(np.uint8))
    return [tuple(planes)]


# the 128x64 pictures of ROADMAP C3 (kind, seed, QP): intra, PCM 8x8 to
# 32x32 with pcm_loop_filter_disabled.  On each, a PCM trial of the RDO
# quadtree wins a leaf that the split then replaces; an encoder that keeps
# that trial's pcm marks restores deblocked samples of non-PCM CUs
# (K8) and writes a hash SEI that the decoders report as MISMATCH.  On
# "mixed" the binary half stays PCM, so the restore has samples to put
# back.
C3_CASES = {"mixed_qp16": ("mixed", 0, 16),
            "uniform_qp16": ("uniform", 1, 16),
            "binary_qp22": ("binary", 0, 22)}


def c3_config(mod, qp):
    """The EncoderConfig of the C3 pictures in the encoder module mod."""
    cfg = mod.EncoderConfig(128, 64, gop="intra", qp=qp)
    cfg.pcm_enabled = cfg.pcm_filter_disabled = True
    cfg.log2_min_ipcm, cfg.log2_max_ipcm = 3, 5
    return cfg


def decode_statuses(data, device):
    """(pictures, hash SEI statuses) of the port's decode_batch with the
    hash check: the status of every picture whose hash SEI was checked,
    in decode order."""
    from libhm_tpu_torch.hostdec.decoder import Decoder
    from libhm_tpu_torch.parallel.dag_decode import decode_batch
    seen = []
    real = Decoder._verify_hash

    def spy(self, dp):
        checked = self._pending_hash is not None
        real(self, dp)
        if checked:
            seen.append(dp.hash_status)
    Decoder._verify_hash = spy
    try:
        outs = decode_batch(data, device=device, check_sei_hash=True)
    finally:
        Decoder._verify_hash = real
    return outs, seen


# the encoder cases of tests/test_torch_encoder_jax.py (against the JAX
# encoder) and tests/test_torch_cuda.py (the card against the CPU)
DEBLOCK = LF.PASS_V | LF.PASS_H


# name: (width, height, pictures, frames keywords (None: pcm_frames),
# EncoderConfig keywords, config attributes, the native path, the masks of
# each picture's launches, the masks whose launches change samples)
LF_ALL = [DEBLOCK, LF.PASS_SAO]
CASES = {
    "intra": (64, 48, 2, {}, dict(gop="intra", qp=27), {}, True, LF_ALL,
              LF_ALL),
    "lowdelayP": (64, 48, 3, {}, dict(gop="lowdelayP", qp=27), {}, True,
                  LF_ALL, LF_ALL),
    "randomaccess": (64, 48, 3, {}, dict(gop="randomaccess", qp=27), {},
                     True, LF_ALL, LF_ALL),
    "slices_tiles": (512, 128, 2, {}, dict(gop="lowdelayP", qp=27),
                     dict(tile_cols=2, slice_ctus=3, lf_cross_slices=False),
                     True, LF_ALL, LF_ALL),
    "sao_no_deblock": (64, 48, 2, {}, dict(gop="intra", qp=37),
                       dict(deblock=False), True, [LF.PASS_SAO],
                       [LF.PASS_SAO]),
    "pcm_restore": (128, 64, 1, None, dict(gop="intra", qp=16),
                    dict(pcm_enabled=True, pcm_filter_disabled=True,
                         log2_min_ipcm=3, log2_max_ipcm=5), False, LF_ALL,
                    [DEBLOCK]),
    "rext422_10b": (64, 48, 2, dict(bd=10, chroma=2),
                    dict(gop="intra", bit_depth=10, chroma_format_idc=2),
                    {}, False, LF_ALL, LF_ALL),
    # the one-pass debug path (HEVC_ENC_1PASS=1): deblocking only, as it
    # writes no SAO syntax
    "one_pass": (64, 48, 2, {}, dict(gop="intra", qp=27), dict(sao=0),
                 False, [DEBLOCK], [DEBLOCK]),
}
# environment variables a case encodes under
ENV = {"one_pass": {"HEVC_ENC_1PASS": "1"}}


def encode(mod, name, **enc_kw):
    """(stream, encoder) of CASES[name] through the encoder module `mod`
    (the port's or the JAX package's libhm_tpu*.encoder.encoder)."""
    w, h, n, fr_kw, cfg_kw, attrs = CASES[name][:6]
    pics = pcm_frames(w, h) if fr_kw is None else frames(w, h, n, **fr_kw)
    cfg = mod.EncoderConfig(w, h, **cfg_kw)
    for k, v in attrs.items():
        setattr(cfg, k, v)
    env = ENV.get(name, {})
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        enc = mod.IntraEncoder(cfg, **enc_kw)
        return enc.encode_stream(pics), enc
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
