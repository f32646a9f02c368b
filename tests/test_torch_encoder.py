"""The port's encoder (libhm_tpu_torch.encoder, apps/enc_app.py) on the
CPU, with no JAX:

- the CLI, `python -m libhm_tpu_torch.apps.enc_app -c testdata/<name>.cfg
  --device cpu`, on the source that the cfg's recipe makes
  (tests/enc_cases.py), writes exactly the committed stream: the Python
  path (intra_search), SAO at 14 and 16 bits, transform skip;
- the encoder's two launches of the loop-filter kernel per picture
  (deblocking, then SAO on the deblocked planes) compute what one launch
  of all three passes computes, on seeded levels (tests/lf_cases.py),
  single and multi SAO forms, 4:2:0, 4:2:2 and 12-bit chroma;
- importing the encoder and encoding on the Python path loads neither JAX
  nor the JAX package;
- the encoder runs its filter on the card unless asked for the CPU, and a
  missing card raises.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from libhm_tpu_torch.ops import loopfilter as LF
import torch_threads  # noqa: F401
from enc_cases import frames, recipe_source
from lf_cases import level_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["rext444_16b_intra_160x96",
                                  "main14_intra_160x96"])
def test_recipe_bytes(name, tmp_path):
    cfg = os.path.join("testdata", f"{name}.cfg")
    src, _ = recipe_source(os.path.join(ROOT, cfg))
    (tmp_path / "src.yuv").write_bytes(src)
    out = tmp_path / "out.bin"
    r = subprocess.run(
        [sys.executable, "-m", "libhm_tpu_torch.apps.enc_app", "-c", cfg,
         "-i", str(tmp_path / "src.yuv"), "-b", str(out), "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    want = open(os.path.join(ROOT, "testdata", f"{name}.bin"), "rb").read()
    assert out.read_bytes() == want


@pytest.mark.parametrize("case", [
    dict(),
    dict(multi=True),
    dict(chroma=2, multi=True),
    dict(bd_l=12, chroma=1),
    dict(chroma=0, offsets=False),
], ids=["420", "420_multi", "422_multi", "12bit", "400"])
def test_split_masks(case):
    """Deblocking in one launch, then SAO in another on its output, equals
    V, H and SAO in one launch."""
    rng = np.random.default_rng(15)
    planes, maps, kw = level_case(rng, B=2, Hp=64, Wp=96, H=60, W=88,
                                  **case)
    kw = dict(kw, mask=0)
    whole = LF.loop_filter_level_plain(
        planes, maps, **dict(kw, mask=LF.PASS_V | LF.PASS_H | LF.PASS_SAO))
    deblocked = LF.loop_filter_level_plain(
        planes, maps, **dict(kw, mask=LF.PASS_V | LF.PASS_H))
    split = LF.loop_filter_level_plain(deblocked, maps,
                                       **dict(kw, mask=LF.PASS_SAO))
    for a, b, p in zip(split, whole, planes):
        assert torch.equal(a, b)
    assert any(not torch.equal(d, s) for d, s in zip(deblocked, split))
    assert any(not torch.equal(d, p) for d, p in zip(deblocked, planes))


def test_encode_leaves_jax_out():
    """Importing the encoder and one encode on the Python path (4:2:2, so
    intra_search's mode search) load neither JAX nor the JAX package."""
    code = ("import sys\n"
            "sys.path.insert(0, 'tests')\n"
            "from enc_cases import frames\n"
            "from libhm_tpu_torch.encoder.encoder import IntraEncoder, "
            "EncoderConfig\n"
            "import libhm_tpu_torch.apps.enc_app\n"
            "cfg = EncoderConfig(64, 48, chroma_format_idc=2)\n"
            "enc = IntraEncoder(cfg, device='cpu')\n"
            "assert enc.encode_stream(frames(64, 48, 1, chroma=2))\n"
            "assert not enc._native_ctu_eligible()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'libhm_tpu')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr[-2000:]


def test_device_default(tmp_path):
    """The encoder and enc_app default to the card: where there is none,
    both raise; device="cpu" selects the plain versions."""
    from libhm_tpu_torch.apps import enc_app
    from libhm_tpu_torch.encoder.encoder import EncoderConfig, IntraEncoder
    cfg = EncoderConfig(64, 48)
    assert IntraEncoder(cfg, device="cpu").device == torch.device("cpu")
    y, u, v = frames(64, 48, 1)[0]
    (tmp_path / "src.yuv").write_bytes(y.tobytes() + u.tobytes() +
                                       v.tobytes())
    argv = ["-i", str(tmp_path / "src.yuv"), "-b", str(tmp_path / "o.bin"),
            "-wdt", "64", "-hgt", "48", "-f", "1"]
    if torch.cuda.is_available():
        assert IntraEncoder(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            IntraEncoder(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            enc_app.main(argv)
        with pytest.raises(RuntimeError, match="CUDA"):
            IntraEncoder(cfg, device="cuda:0")
    assert enc_app.main(argv + ["--device", "cpu"]) == 0
    assert (tmp_path / "o.bin").stat().st_size > 0
