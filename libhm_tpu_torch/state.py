"""The decoder's constant tables as device tensors.

A codec carries no learned weights; the state the port must share with
the JAX package is its constant tables.  `tables_from_numpy` builds them on
a device from the numpy arrays the host half holds (libhm_tpu.hostdec) and
from the port's own static tables, so a test can hold each one against the
JAX package's jnp tables element by element.
"""
import torch

from .hostdec.tables import DCT, DST4, INV_QUANT_SCALES

from .ops import deblock as DK
from .ops import interp as MK
from .ops import intra as IK


def tables_from_numpy(device):
    """{name: tensor} of every constant table the kernels compute with."""
    t = {f"dct{n}": torch.as_tensor(DCT[n], device=device)
         for n in (4, 8, 16, 32)}
    t["dst4"] = torch.as_tensor(DST4, device=device)
    t["inv_quant_scales"] = torch.as_tensor(INV_QUANT_SCALES, device=device)
    t["beta"] = torch.as_tensor(DK.BETA_TABLE, device=device)
    t["tc"] = torch.as_tensor(DK.TC_TABLE, device=device)
    t["luma_filter"] = torch.as_tensor(MK.LUMA_FILTER, dtype=torch.int32,
                                       device=device)
    t["chroma_filter"] = torch.as_tensor(MK.CHROMA_FILTER, dtype=torch.int32,
                                         device=device)
    for n in (4, 8, 16, 32):
        ext, row, frac, vert = IK._ang_tables(n)
        wc, we = IK._strong_weights(n)
        offx, offy = IK._border_offsets(n)
        for name, a in (("ang_ext", ext), ("ang_row", row),
                        ("ang_frac", frac), ("ang_vert", vert),
                        ("strong_wc", wc), ("strong_we", we),
                        ("border_offx", offx), ("border_offy", offy)):
            t[f"{name}{n}"] = torch.as_tensor(a, device=device)
    return t
