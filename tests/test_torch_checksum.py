"""K7's host half and plain version against the JAX package, on the CPU.

- view_chunks (the launches' view tables, csrc/checksum.cu takes at most
  MAX_VIEWS views a launch as its parameter) lists every view that holds a
  sample exactly once, in order, for 1, 51 (RA 1080p), 64, 65 and 130
  views, and refuses a view with a column stride, another dtype or
  another number of dimensions;
- plane_checksum_plain (K7's plain version) == decode_batch_device's JAX
  checksum, jnp.sum(crop.astype(jnp.uint32)) per cropped view and then the
  sum of the parts, on crops with odd offsets and a total past 2^32.

Inputs are numpy-seeded; equality is exact.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libhm_tpu_torch.ops import checksum as CK
import torch_threads  # noqa: F401


@pytest.mark.parametrize("n", [1, 51, 64, 65, 130])
def test_view_chunks_cover_every_view_once(n):
    rng = np.random.default_rng(n)
    planes = torch.zeros((3, 40, 56), dtype=torch.int32)
    views = []
    for i in range(n):
        t, l = (int(v) for v in rng.integers(0, 5, 2))
        views.append(planes[i % 3, t:t + 1 + i % 30, l:l + 3 + i % 50])
    # an empty crop holds no sample and takes no place in a table
    views.insert(n // 2, planes[0, 5:5, :])
    chunks = CK.view_chunks(views)
    assert len(chunks) == -(-n // CK.MAX_VIEWS)
    assert all(c.dtype == np.int64 and c.shape[1] == 4 and
               1 <= len(c) <= CK.MAX_VIEWS for c in chunks)
    want = [[v.data_ptr(), v.stride(0), v.shape[0], v.shape[1]]
            for v in views if v.numel()]
    assert np.concatenate(chunks).tolist() == want
    # what the kernel cannot walk is refused
    for bad in (planes[0].t(), planes[0].to(torch.int64), planes[0, 0]):
        with pytest.raises(ValueError):
            CK.view_chunks(views[:1] + [bad])


def test_plane_checksum_plain_equals_jax():
    rng = np.random.default_rng(9)
    planes = [rng.integers(0, 1 << 12, (2, 70, 90)).astype(np.int32)
              for _ in range(3)]
    # crops at odd offsets on every side (conf_win), as decode_batch_device
    # cuts them, and three megapixel planes of 4095 that carry the sum past
    # 2^32
    crops = [p[b, 1 + b:67 - b, 3:87 + b] for p in planes for b in range(2)]
    crops += [np.full((1024, 1024), 4095, np.int32)] * 3
    want = int(jnp.sum(jnp.stack([jnp.sum(jnp.asarray(c).astype(jnp.uint32))
                                  for c in crops])))
    assert sum(int(c.astype(np.int64).sum()) for c in crops) > 1 << 32
    got = CK.plane_checksum([torch.from_numpy(c) for c in crops])
    assert got.shape == (1,) and got.device.type == "cpu"
    assert int(got.item()) == want
