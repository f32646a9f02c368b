"""The port's decode of coding-tool streams equals the JAX decode_batch
plane by plane (exact), on the CPU: a tiled stream without loop filtering
across tiles (K4's multi form), PCM at a reduced bit depth (K9, K8), and a
PPS scaling list overriding the SPS one (K1's scaled mode), each also at
its HM golden MD5.  Kept apart from test_torch_tools_decode.py because the
JAX decodes compile on the CPU.
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from libhm_tpu_torch.parallel import dag_decode as DD
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = json.load(open(os.path.join(ROOT, "testdata", "golden.json")))


@pytest.mark.parametrize("name", ["tiles_nolfcross_512x128",
                                  "pcm_reduceddepth_160x96",
                                  "customsl_lowdelay_160x96"])
def test_tool_decode_equals_jax(name):
    from libhm_tpu.parallel.dag_decode import decode_batch as jax_decode
    data = open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()
    outs = DD.decode_batch(data, device=torch.device("cpu"))
    buf = b"".join(p.tobytes() for pic in outs for p in pic)
    assert hashlib.md5(buf).hexdigest() == GOLD[name]["decoded_yuv_md5"]
    want = jax_decode(data)
    assert len(outs) == len(want)
    for pic_t, pic_j in zip(outs, want):
        assert len(pic_t) == len(pic_j) == 3
        for a, b in zip(pic_t, pic_j):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)
