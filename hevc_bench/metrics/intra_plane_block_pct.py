"""intra_plane_block_pct (%, program counter; kernels layer): of the
intra blocks K2 reconstructed in the window (the program's "k2" spans, n
= blocks), the share with a sample at or past the width of the
shared-memory lattice the launch reported ("k2.plane_blocks"): blocks
that write past the lattice, and whose neighbours' borders K2 reads from
the plane in global memory.  None without a K2 launch in the window."""
import roofline_intra


def read(run):
    launched = roofline_intra.launches(run) or []
    blocks = sum(k["blocks"] for k in launched)
    if not blocks:
        return None
    return 100.0 * sum(k["plane_blocks"] for k in launched) / blocks
