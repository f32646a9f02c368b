"""Seeded PCM levels for K9 (tests/test_torch_pcm_level.py, the CUDA test,
chip_smoke.py's check_k9 and tools/port_ab.py).

`pcm_blocks` puts one PCM CU of 8, 16 or 32 luma samples (in turn) at the
origin of a `share` of a level's 32x32 luma cells, with its chroma blocks
at the chroma format's subsampling (4:2:2: w x 2w), each component with
its own shift (bit depth - PCM bit depth) and samples below 1 << PCM bit
depth, as `_pcm_level` lists them: (comp, b, x, y, w, h, shift, samples
[h, w]).
"""
import numpy as np

# chroma_format_idc -> (sx, sy) of the chroma planes, None for 4:0:0
FORMATS = {0: None, 1: (1, 1), 2: (1, 0), 3: (0, 0)}


def plane_shapes(fmt, B, Hp, Wp):
    """The [B, Hc, Wc] shapes of the level's planes."""
    sub = FORMATS[fmt]
    return [(B, Hp, Wp)] + ([(B, Hp >> sub[1], Wp >> sub[0])] * 2
                            if sub else [])


def pcm_blocks(rng, fmt, B, Hp, Wp, share=0.5, shifts=(2, 3), bd=10):
    sub = FORMATS[fmt]
    ncomp = 3 if sub else 1
    cells = [(b, y, x) for b in range(B) for y in range(0, Hp, 32)
             for x in range(0, Wp, 32)]
    blocks = []
    for k in rng.permutation(len(cells))[:int(len(cells) * share) + 1]:
        b, y, x = cells[k]
        n = (8, 16, 32)[k % 3]
        for c in range(ncomp):
            sx, sy = (0, 0) if c == 0 else sub
            shift = shifts[c > 0]
            w, h = n >> sx, n >> sy
            blocks.append((c, b, x >> sx, y >> sy, w, h, shift,
                           rng.integers(0, 1 << (bd - shift), (h, w))))
    return blocks
