"""Rewrites of the SPS of a stream, for the port's conformance tests
(tests/test_torch_conformance.py): the same slice data read under other
bit depths, or with a flag of sps_range_extension() set.

- `set_bit_depths(rbsp, luma, chroma)`: bit_depth_luma_minus8 and
  bit_depth_chroma_minus8 recoded as ue(v) (of any length: every field
  after them moves with them, and the RBSP ends with its stop bit again);
- `set_range_flag(rbsp, name)` and `rewrite_sps(data, edit)`:
  tools/make_extprec_stream.py's (one flag of sps_range_extension() set;
  every SPS NAL unit of an Annex-B stream rebuilt with edit(rbsp) and
  emulation prevention).

Each edit parses the result back with the port's parse_sps and raises
unless exactly the fields it meant to change did.  The slice data is left
as it is: the caller chooses streams whose parse does not depend on the
changed fields (no SAO, whose offsets' cMax depends on the bit depth up to
10 bits, and no PCM).
"""
import importlib.util
import os

import numpy as np

from libhm_tpu_torch.hostdec import params as P
from libhm_tpu_torch.hostdec.bitstream import BitReader

_spec = importlib.util.spec_from_file_location(
    "make_extprec_stream",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "tools", "make_extprec_stream.py"))
_tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_tool)
set_range_flag, rewrite_sps = _tool.set_range_flag, _tool.rewrite_sps


def _ue(v):
    """ue(v) bits of v."""
    n = (v + 1).bit_length()
    return [0] * (n - 1) + [int(b) for b in format(v + 1, "b")]


def set_bit_depths(rbsp, luma, chroma):
    """The SPS RBSP with BitDepthY = luma and BitDepthC = chroma."""
    before = P.parse_sps(rbsp)
    r = BitReader(rbsp)
    r.u(4)                                  # sps_video_parameter_set_id
    sub = r.u(3)                            # sps_max_sub_layers_minus1
    r.flag()
    P._parse_ptl(r, sub)
    r.ue()                                  # sps_seq_parameter_set_id
    if r.ue() == 3:                         # chroma_format_idc
        r.flag()
    r.ue()
    r.ue()
    if r.flag():                            # conformance_window_flag
        for _ in range(4):
            r.ue()
    start = r.pos
    r.ue()
    r.ue()
    bits = np.unpackbits(np.frombuffer(rbsp, np.uint8))
    body = bits[:int(np.nonzero(bits)[0][-1])]     # up to the stop bit
    out = np.packbits(np.concatenate(
        [body[:start], _ue(luma - 8), _ue(chroma - 8), body[r.pos:],
         [1]]).astype(np.uint8)).tobytes()
    after = P.parse_sps(out)
    want = {k for k, v in (("bit_depth_luma", luma),
                           ("bit_depth_chroma", chroma))
            if getattr(before, k) != v}
    changed = {k for k, v in vars(before).items() if getattr(after, k) != v}
    if changed != want:
        raise ValueError(f"the rewrite changed {sorted(changed)}, not "
                         f"{sorted(want)}")
    return out
