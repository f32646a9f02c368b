"""Port hygiene and shared state.

- libhm_tpu_torch and chip_smoke.py import neither JAX nor anything of
  the JAX package (libhm_tpu), directly or indirectly: the port keeps its
  own copy of the host half (libhm_tpu_torch.hostdec);
- the port's constant tables (state.tables_from_numpy) equal the JAX
  package's jnp tables element by element, and the literal tables in the
  CUDA sources equal the numpy ones;
- the kernel wrappers refuse what the kernels do not take.
"""
import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from libhm_tpu_torch.ops import interp as MK

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "libhm_tpu_torch")


def _py_files():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imports(path):
    """Absolute module names imported by one file (relative ones resolved)."""
    pkg = os.path.relpath(path, ROOT)[:-3].split(os.sep)[:-1]
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg[:len(pkg) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module
            yield mod


@pytest.mark.parametrize("path", sorted(_py_files()),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_no_jax_and_only_hostdec(path):
    """No JAX, and of the host half only the port's own hostdec copy."""
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "libhm_tpu"), (path, mod)


def test_import_leaves_jax_out():
    """Importing the entry points and decoding a stream on the CPU loads
    neither JAX nor the JAX package."""
    code = ("import sys\n"
            "import libhm_tpu_torch.state, libhm_tpu_torch.recon_torch\n"
            "from libhm_tpu_torch.parallel.dag_decode import decode_batch, "
            "decode_batch_device\n"
            "data = open('testdata/intra_64x64.bin', 'rb').read()\n"
            "assert decode_batch(data, device='cpu')\n"
            "assert decode_batch_device(data, device='cpu')[3]\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'libhm_tpu')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr[-2000:]


def test_tables_equal_jax():
    """state.tables_from_numpy == the JAX package's jnp/numpy tables."""
    from libhm_tpu.ops import deblock as JD
    from libhm_tpu.ops import interp as JM
    from libhm_tpu.ops import intra as JI
    from libhm_tpu.ops import transform as JT
    from libhm_tpu_torch.state import tables_from_numpy
    t = {k: v.numpy() for k, v in tables_from_numpy("cpu").items()}
    for n in (4, 8, 16, 32):
        np.testing.assert_array_equal(t[f"dct{n}"], JT._mats(n, False)[1])
        ext, row, frac, vert = JI._ang_tables(n)
        np.testing.assert_array_equal(t[f"ang_ext{n}"], ext)
        np.testing.assert_array_equal(t[f"ang_row{n}"], row)
        np.testing.assert_array_equal(t[f"ang_frac{n}"], frac)
        np.testing.assert_array_equal(t[f"ang_vert{n}"], vert)
        wc, we = JI._strong_weights(n)
        np.testing.assert_array_equal(t[f"strong_wc{n}"], wc)
        np.testing.assert_array_equal(t[f"strong_we{n}"], we)
        ox, oy = JI._border_offsets(n)
        np.testing.assert_array_equal(t[f"border_offx{n}"], ox)
        np.testing.assert_array_equal(t[f"border_offy{n}"], oy)
    np.testing.assert_array_equal(t["dst4"], JT._mats(4, True)[1])
    np.testing.assert_array_equal(t["beta"], np.asarray(JD.BETA_TABLE))
    np.testing.assert_array_equal(t["tc"], np.asarray(JD.TC_TABLE))
    np.testing.assert_array_equal(t["inv_quant_scales"],
                                  np.asarray(JT.INV_QUANT_SCALES))
    np.testing.assert_array_equal(t["luma_filter"],
                                  np.asarray(JM.LUMA_FILTER))
    np.testing.assert_array_equal(t["chroma_filter"],
                                  np.asarray(JM.CHROMA_FILTER))
    assert (JM.IF_PREC, JM.IF_OFFS) == (MK.IF_PREC, MK.IF_OFFS)


def _cuda_table(fname, name):
    src = open(os.path.join(PKG, "csrc", fname)).read()
    m = re.search(name + r"(?:\[\d+\])+\s*=\s*\{(.*?)\};", src, re.S)
    assert m, name
    return np.array([int(v) for v in re.findall(r"-?\d+", m.group(1))])


def test_cuda_tables_equal_numpy():
    from libhm_tpu_torch.hostdec.refimpl import ANG_TABLE
    from libhm_tpu_torch.state import tables_from_numpy
    t = {k: v.numpy() for k, v in tables_from_numpy("cpu").items()}
    np.testing.assert_array_equal(_cuda_table("residual.cu", "kDct32"),
                                  t["dct32"].ravel())
    np.testing.assert_array_equal(_cuda_table("residual.cu", "kDst4"),
                                  t["dst4"].ravel())
    np.testing.assert_array_equal(
        _cuda_table("residual.cu", "kInvQuantScales"), t["inv_quant_scales"])
    np.testing.assert_array_equal(_cuda_table("deblock.cu", "kBeta"),
                                  t["beta"])
    np.testing.assert_array_equal(_cuda_table("deblock.cu", "kTc"), t["tc"])
    np.testing.assert_array_equal(_cuda_table("intra.cu", "kAng"),
                                  np.asarray(ANG_TABLE))
    np.testing.assert_array_equal(_cuda_table("mc.cu", "kLumaFilter"),
                                  t["luma_filter"].ravel())
    np.testing.assert_array_equal(_cuda_table("mc.cu", "kChromaFilter"),
                                  t["chroma_filter"].ravel())


def test_wrappers_refuse_cpu_tensors():
    from libhm_tpu_torch.kernels.build import check
    with pytest.raises(ValueError, match="CUDA"):
        check(torch.zeros(4, dtype=torch.int32), "x", torch.int32, 1)


def test_build_rule_sees_every_source():
    from libhm_tpu_torch.kernels import build
    names = sorted(os.path.basename(s) for s in build._sources())
    assert names == ["checksum.cu", "deblock.cu", "errors.cu", "intra.cu",
                     "mc.cu", "residual.cu", "sao.cu"]
    assert build.LIB_PATH.startswith(os.path.join(PKG, "_build"))


def _hostdec_copies():
    src = os.path.join(ROOT, "libhm_tpu", "hostdec")
    dst = os.path.join(PKG, "hostdec")
    for d, _, files in os.walk(dst):
        for f in sorted(files):
            if f.endswith((".py", ".cpp", ".h")) or f == "Makefile":
                rel = os.path.relpath(os.path.join(d, f), dst)
                if rel != "__init__.py":
                    yield rel, src, dst
    yield "envvar.py", os.path.join(ROOT, "libhm_tpu", "utils"), \
        os.path.join(PKG, "utils")


# the two copies that were changed: decoder.py lost the JAX package's
# recon="tpu" backend, native_bridge.py builds only the parser libraries
_EDITED = {"decoder.py", "native_bridge.py"}


@pytest.mark.parametrize("rel,src,dst", list(_hostdec_copies()),
                         ids=[rel for rel, _, _ in _hostdec_copies()])
def test_hostdec_copy_names_its_source(rel, src, dst):
    """Each copied host file names its source on its first line and, unless
    it is one of the edited copies, equals it below that line."""
    lines = open(os.path.join(dst, rel)).read().split("\n")
    origin = os.path.relpath(os.path.join(src, rel), ROOT)
    assert lines[0] in (f"# Copied from {origin}", f"// Copied from {origin}")
    if rel not in _EDITED:
        assert "\n".join(lines[1:]) == open(os.path.join(src, rel)).read()
