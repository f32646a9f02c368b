"""K2's plane path on the card: a luma CTU row wider than the
shared-memory lattice K2 holds (csrc/intra.cu keeps the row's border
samples for columns below Wl and reads those past it from the plane).

Marked `cuda`: needs an NVIDIA GPU and nvcc, and skips elsewhere (the
check happens inside the fixture).  On a GPU host:

    python -m pytest tests/test_torch_intra_plane.py -q -m cuda --noconftest

Two CTU rows of a seeded random luma layout, 4096 samples wide (wider than
the lattice of any card), through ops.intra.intra_wavefront on CUDA, equal
hevc_bench/plain_intra.py exactly; the launch reports its lattice's width
(the "k2.lattice" count) and counts, in ops.intra.WORK and its
"k2.plane_blocks" count, the blocks with a sample past it.
"""
import pytest
import torch

import intra_layouts as LY
from libhm_tpu_torch.ops import intra as IK
from libhm_tpu_torch.utils import obs
import torch_threads  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.parametrize("ctas", [0, 1])
@pytest.mark.parametrize("bd", [10, 16])
def test_plane_path_equals_reference(gpu, bd, ctas):
    W, H = 4096, 128
    blocks = LY.random_layout(40 + bd, W, H, bd)
    obs.reset()
    before = IK.WORK["plane_blocks"]
    got, table = LY.port_reconstruct(blocks, W, H, bd, gpu, ctas=ctas)
    torch.cuda.synchronize()
    want = LY.reference(blocks, W, H, bd)
    assert torch.equal(got.to(torch.int64), want), \
        int((got.to(torch.int64) != want).sum())
    lattice = [s.n for s in obs.spans() if s.name == "k2.lattice"]
    assert len(lattice) == 1
    wl = lattice[0]
    assert 0 < wl < W and wl % 4 == 0
    past = sum(1 for x, _, n, _, _, _ in blocks if x + n > wl)
    assert past > 0
    assert IK.WORK["plane_blocks"] - before == past
    assert [s.n for s in obs.spans() if s.name == "k2.plane_blocks"] == \
        [past]
    assert len(table["rows"]) == len(blocks)
