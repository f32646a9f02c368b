"""The port's multi-device decode on the CPU (plain torch versions).

A `devices=` list on decode_batch, decode_batch_device, decode_streams and
decode_intra_batch splits each reference-DAG level's pictures into
contiguous shards of ceil(B / m) pictures over the m list entries, the
picture axis that the JAX package shards over a `mesh=`.  Several "cpu"
entries stand in for several cards, as the JAX tests use a virtual CPU
mesh (tests/conftest.py):

- decode_batch with 1, 2, 3 and 8 entries equals the golden MD5 and the
  one-device decode plane for plane, and equals the JAX decode_batch over
  a 3-device mesh array for array;
- each level splits into ceil(B / m)-sized contiguous shards (a spy on
  the residual stage, which runs once per shard);
- decode_batch_device adds one 4-byte checksum per entry holding
  pictures; decode_intra_batch splits an all-intra stream;
- decode_streams takes JAX's `parse` and `check_sei_hash` keywords and
  checks every hash SEI;
- an empty list, a `device` that is not devices[0] and a CUDA entry on a
  host without the card are refused;
- entry.dryrun_multidevice, the port of __graft_entry__'s dry run.
"""
import hashlib
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from libhm_tpu_torch.parallel import batch_decode as BD
from libhm_tpu_torch.parallel import dag_decode as DD
from libhm_tpu_torch.utils import xfer
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = json.load(open(os.path.join(ROOT, "testdata", "golden.json")))
CPU = torch.device("cpu")
RA = "tids4_ra_160x96"            # levels of 1, 1, 1, 2 pictures
RA416 = "randomaccess_416x240"    # levels of 1, 1, 1, 1, 3, 3, 1, 1, 3, 2


def _data(name):
    return open(os.path.join(ROOT, "testdata", GOLD[name]["bitstream"]),
                "rb").read()


def _md5(outs):
    return hashlib.md5(b"".join(p.tobytes() for pic in outs
                                for p in pic)).hexdigest()


_ONE = {}


def _one_device(name):
    """decode_batch(device="cpu"), once per stream and worker."""
    if name not in _ONE:
        _ONE[name] = DD.decode_batch(_data(name), device=CPU)
    return _ONE[name]


def _assert_planes_equal(got, want):
    assert len(got) == len(want)
    for pic_g, pic_w in zip(got, want):
        assert len(pic_g) == len(pic_w)
        for a, b in zip(pic_g, pic_w):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_decode_batch_devices(k):
    outs = DD.decode_batch(_data(RA), devices=["cpu"] * k)
    assert _md5(outs) == GOLD[RA]["decoded_yuv_md5"]
    _assert_planes_equal(outs, _one_device(RA))


def test_decode_batch_eight_devices_golden():
    """Port of the JAX test_dag_decode_mesh_sharded."""
    outs = DD.decode_batch(_data(RA416), devices=["cpu"] * 8)
    assert len(outs) == GOLD[RA416]["frames"]
    assert _md5(outs) == GOLD[RA416]["decoded_yuv_md5"]


def test_decode_batch_equals_jax_mesh():
    import jax
    from jax.sharding import Mesh
    from libhm_tpu.parallel.dag_decode import decode_batch as jax_decode
    devs = jax.devices()
    if len(devs) < 3:
        pytest.skip("needs the virtual CPU mesh of tests/conftest.py")
    want = jax_decode(_data(RA), mesh=Mesh(np.array(devs[:3]), ("pics",)))
    got = DD.decode_batch(_data(RA), devices=["cpu"] * 3)
    _assert_planes_equal(got, [[np.asarray(p) for p in pic]
                               for pic in want])


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_level_shards(monkeypatch):
    """Every level splits into contiguous shards of ceil(B / m) pictures,
    shard k for entry k, in reference_levels' order; the kernel wrappers
    run as often as chip_smoke.py's predicted_launches says the kernels
    launch on the card (K1 where a component has a TU; K2 once a shard
    with an intra block, over every component)."""
    from libhm_tpu_torch.hostdec.decoder import Decoder
    from libhm_tpu_torch.ops import interp as MK
    from libhm_tpu_torch.ops import intra as IK
    from libhm_tpu_torch.ops import loopfilter as LF
    from libhm_tpu_torch.ops import transform as TK
    m = 2
    dec = Decoder(parse="native", recon="collect")
    dec.decode_annexb(_data(RA416))
    levels = DD.reference_levels(dec.collected)
    assert [len(lv) for lv in levels] == [1, 1, 1, 1, 3, 3, 1, 1, 3, 2]
    shards = []
    real = BD._residual_planes_batch_device

    def spy(items, Bp, device):
        shards.append([id(it["dp"]) for it in items])
        assert Bp == len(items)
        return real(items, Bp, device)
    monkeypatch.setattr(BD, "_residual_planes_batch_device", spy)
    calls = dict.fromkeys(["residual_scatter", "intra_wavefront",
                           "loop_filter_level", "mc_grid"], 0)
    for mod, fn, name, runs in (
            (TK, "residual_table", "residual_scatter",
             lambda planes, table, *a: table.rows.shape[0] > 0),
            (IK, "intra_wavefronts", "intra_wavefront", None),
            (LF, "loop_filter_level", "loop_filter_level", None),
            (MK, "mc_grid", "mc_grid", None)):
        def counted(*a, _real=getattr(mod, fn), _name=name, _runs=runs,
                    **kw):
            calls[_name] += _runs is None or bool(_runs(*a))
            return _real(*a, **kw)
        monkeypatch.setattr(mod, fn, counted)
    DD._recon_levels(dec.collected, ["cpu"] * m, download=False)
    assert _chip_smoke().predicted_launches(dec.collected, m) == \
        (calls, 14, 2)
    want = []
    for lv in levels:
        per = -(-len(lv) // m)
        want += [[id(it["dp"]) for it in lv[i:i + per]]
                 for i in range(0, len(lv), per)]
    assert len(shards) == len(want) == 14
    assert shards == want
    for lv in levels:
        per = -(-len(lv) // m)
        assert [it["device_index"] for it in lv] == \
            [i // per for i in range(len(lv))]


def test_one_entry_launches_what_device_launches(monkeypatch):
    """devices=[d] makes the stage calls and the uploads of device=d."""
    calls = []
    real = BD._residual_planes_batch_device

    def spy(items, Bp, device):
        calls.append(Bp)
        return real(items, Bp, device)
    monkeypatch.setattr(BD, "_residual_planes_batch_device", spy)
    counted = []
    for kw in (dict(device=CPU), dict(devices=["cpu"])):
        calls.clear()
        xfer.reset()
        DD.decode_batch(_data(RA), **kw)
        counted.append((list(calls), dict(xfer.UPLOADS), xfer.H2D))
    assert counted[0] == counted[1]
    assert "peer" not in counted[0][1]


def test_decode_batch_device_two_devices():
    xfer.reset()
    _, _, csum, n = DD.decode_batch_device(_data(RA), devices=["cpu"] * 2)
    outs = _one_device(RA)
    assert n == len(outs) == GOLD[RA]["frames"]
    assert csum == DD.cropped_checksum(outs)
    assert xfer.D2H == 8


def test_decode_intra_batch_two_devices():
    name = "intra_main10_416x240"
    dps = BD.decode_intra_batch(_data(name), devices=["cpu"] * 2,
                                check_sei_hash=True)
    assert len(dps) == GOLD[name]["frames"]
    assert [dp.hash_status for dp in dps] == ["OK"] * len(dps)
    assert hashlib.md5(b"".join(p.tobytes() for dp in dps
                                for p in dp.cropped())).hexdigest() == \
        GOLD[name]["decoded_yuv_md5"]


ENTRY_POINTS = {
    "decode_batch": lambda **kw: DD.decode_batch(b"", **kw),
    "decode_batch_device": lambda **kw: DD.decode_batch_device(b"", **kw),
    "decode_streams": lambda **kw: DD.decode_streams([b""], **kw),
    "decode_intra_batch": lambda **kw: BD.decode_intra_batch(b"", **kw)}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
@pytest.mark.parametrize("kw", [
    dict(devices=[]),
    dict(device="cpu", devices=["cuda:0", "cpu"]),
    dict(device="cuda", devices=["cpu", "cpu"])],
    ids=["empty", "disagree", "disagree-cuda"])
def test_devices_refused(entry, kw):
    with pytest.raises(ValueError):
        ENTRY_POINTS[entry](**kw)


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_absent_cuda_entry_refused(entry):
    """No silent move to the CPU: a CUDA entry the host does not have (the
    card itself here, one past the last card on a GPU host) raises."""
    absent = "cuda" if not torch.cuda.is_available() else \
        f"cuda:{torch.cuda.device_count()}"
    with pytest.raises(RuntimeError):
        ENTRY_POINTS[entry](devices=["cpu", absent])


def test_dryrun_multidevice_cpu(capsys):
    from libhm_tpu_torch import entry
    assert entry.dryrun_multidevice(3, device="cpu") == ["cpu"] * 3
    assert "3 entries -> ['cpu', 'cpu', 'cpu']" in capsys.readouterr().out


@pytest.mark.parametrize("k", [1, 3])
def test_decode_streams_jax_keywords(monkeypatch, k):
    """decode_streams with JAX's keywords checks every picture's hash SEI
    (every picture of these goldens carries one)."""
    from libhm_tpu_torch.hostdec.decoder import Decoder
    names = ["tids4_ra_160x96", "chromaqp_ra_160x96"]
    seen = []
    real = Decoder._verify_hash

    def spy(self, dp):
        # (the control plane also calls it with no hash pending: in collect
        # mode a picture's hash SEI waits in its item for the pixels)
        checked = self._pending_hash is not None
        real(self, dp)
        if checked:
            seen.append(dp.hash_status)
    monkeypatch.setattr(Decoder, "_verify_hash", spy)
    outs = DD.decode_streams([_data(n) for n in names],
                             devices=["cpu"] * k, parse="native",
                             check_sei_hash=True)
    for n, o in zip(names, outs):
        assert _md5(o) == GOLD[n]["decoded_yuv_md5"]
    assert seen == ["OK"] * sum(GOLD[n]["frames"] for n in names)
