"""Port hygiene and shared state.

- libhm_tpu_torch (the encoder included), chip_smoke.py and the port's
  harness (bench_torch.py, tools/bench_kernels_torch.py) import neither
  JAX nor anything of the JAX package (libhm_tpu), directly or
  indirectly: the port keeps its own copy of the host half
  (libhm_tpu_torch.hostdec) and of the encoder;
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
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "libhm_tpu_torch")


def _py_files():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "bench_torch.py")
    yield os.path.join(ROOT, "tools", "bench_kernels_torch.py")


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


def test_scan_sees_the_encoder():
    """The import scan below covers the encoder's modules and its CLI."""
    rels = {os.path.relpath(p, PKG) for p in _py_files()}
    src = os.path.join(ROOT, "libhm_tpu", "encoder")
    want = {os.path.join("encoder", f) for f in os.listdir(src)
            if f.endswith(".py")} | {os.path.join("apps", "enc_app.py")}
    assert want <= rels, want - rels


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
            "import libhm_tpu_torch.api, libhm_tpu_torch.entry\n"
            "import libhm_tpu_torch.apps.dec_app\n"
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
    np.testing.assert_array_equal(_cuda_table("loopfilter.cu", "kBeta"),
                                  t["beta"])
    np.testing.assert_array_equal(_cuda_table("loopfilter.cu", "kTc"),
                                  t["tc"])
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
    assert names == ["checksum.cu", "errors.cu", "intra.cu",
                     "loopfilter.cu", "mc.cu", "pcm.cu", "probe.cu",
                     "residual.cu"]
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
    for rel, sub in (("envvar.py", "utils"), ("trace.py", "utils"),
                     ("api.py", ""), ("dec_app.py", "apps"),
                     ("enc_app.py", "apps"), ("annexb_bytecount.py", "apps"),
                     ("bitrate_targeting.py", "apps"),
                     ("convert_bitdepth.py", "apps")):
        yield rel, os.path.join(ROOT, "libhm_tpu", sub), os.path.join(PKG, sub)
    # the encoder: every module of libhm_tpu/encoder but its empty
    # __init__.py
    src = os.path.join(ROOT, "libhm_tpu", "encoder")
    for f in sorted(os.listdir(src)):
        if f.endswith(".py") and f != "__init__.py":
            yield f, src, os.path.join(PKG, "encoder")


# the copies that were changed: decoder.py replaces the JAX package's
# recon="tpu" backend with recon="torch" (and its device argument),
# native_bridge.py builds only the parser libraries, api.py and dec_app.py
# default to recon="torch" on the card and take a device, trace.py's usage
# line names the port's module; refimpl.py and recon_np.py follow H.265's
# residual under extended precision (no int16 clips, stage 1 clipped to
# +-2^max_dyn_range), where the JAX package's copies clip to int16;
# encoder.py takes a device and runs its in-loop deblocking and SAO through
# the loop-filter kernel (parallel/device_filters.py PictureFilter) where
# the JAX package's runs hostdec/loopfilter_np, and rolls back a rejected
# PCM trial's pcm marks with the other CU maps (the JAX package's leaves
# them, and pcm_loop_filter_disabled's restore then puts deblocked samples
# of non-PCM CUs back); options.py carries PCMFilterDisableFlag from a cfg
# into pcm_filter_disabled, which the JAX package's config build drops;
# enc_app.py takes --device (default cuda) and names the port's module;
# stats.py's usage text, which its main prints, names the port's module;
# slicedec.py and native/sliceparse.cpp start PCM samples at the next byte
# boundary at or after the position after pcm_flag's flush, where the JAX
# package's skip a byte more when the flush ends on a boundary (ROADMAP
# C13); recon_np.py and native/recon.cpp scale the luma residual of
# cross-component prediction by the two bit depths (H.265 8.6.6, ROADMAP
# C4), and with motion.py take weighted-prediction offsets unshifted under
# high_precision_offsets_enabled_flag (H.265 7.4.7.3, ROADMAP C10);
# motion.py, native/recon.cpp and encoder.py predict with H.265's shifts
# above 12 bits (8.5.3.3.3.1 and 8.5.3.3.4.2: the full-sample
# intermediate's Max(2, 14 - bd) and the default bi average's
# Max(3, 15 - bd), ROADMAP C9 and C11), recon.cpp on int32 intermediates
# there; native/hevcdec.h makes the native recon's samples 16-bit unsigned
# (ROADMAP C8), so native/libhmdec.cpp casts its planes to the short* of
# libHMDecoder.h, and native/api.cpp's and native_bridge.py's comments say
# so; libhmdec.cpp also outputs every picture of a coded video sequence
# before an IRAP picture with NoRaslOutputFlag starts the next (Rec.
# C.5.2.2), where the JAX package's interleaves the two by POC; the
# Makefile builds with -fno-gnu-unique, so a process that has loaded the
# JAX package's build of these sources (another ReconCtx layout) does not
# lend it its static locals; native/encsearch.cpp adds an int32 form of the
# motion search (enc_me_search32, enc_bi_refine32, enc_interp_luma32) that
# the encoder runs above 12 bits, where the int16 form narrowed samples,
# templates and first-stage intermediates (ROADMAP C14)
_EDITED = {"decoder.py", "native_bridge.py", "api.py", "dec_app.py",
           "trace.py", "refimpl.py", "recon_np.py", "encoder.py",
           "enc_app.py", "options.py", "stats.py", "slicedec.py",
           "motion.py", os.path.join("native", "sliceparse.cpp"),
           os.path.join("native", "recon.cpp"),
           os.path.join("native", "hevcdec.h"),
           os.path.join("native", "libhmdec.cpp"),
           os.path.join("native", "api.cpp"),
           os.path.join("native", "Makefile"),
           os.path.join("native", "encsearch.cpp")}

# modules of the JAX package whose counterpart in the port has another name
_RENAMED = {os.path.join("libhm_tpu", "recon_tpu.py"):
            os.path.join("libhm_tpu_torch", "recon_torch.py")}


def _modules(top):
    """The Python modules under ROOT/top, as paths relative to ROOT."""
    for d, _, files in os.walk(os.path.join(ROOT, top)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(d, f), ROOT)


def test_every_module_has_a_counterpart():
    """The file-list diff of libhm_tpu/ against libhm_tpu_torch/: every
    module of the JAX package has a module of the same name in the port,
    or the one named in _RENAMED."""
    port = set(_modules("libhm_tpu_torch"))
    missing = []
    for rel in sorted(_modules("libhm_tpu")):
        want = _RENAMED.get(rel, "libhm_tpu_torch" + rel[len("libhm_tpu"):])
        if want not in port:
            missing.append(rel)
    assert not missing, missing
    assert all(r in port for r in _RENAMED.values())


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
