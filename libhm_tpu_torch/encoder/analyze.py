# Copied from libhm_tpu/encoder/analyze.py
"""Encode statistics accumulation and summaries (reference TEncAnalyze.h:
printOut / printSummary — the per-slice-type PSNR/bitrate tables the
reference encoder prints at the end of every run)."""
import math

import numpy as np


def psnr(orig, recon, bit_depth):
    """PSNR of one component plane (reference xCalculateAddPSNR)."""
    o = orig.astype(np.int64)
    r = recon.astype(np.int64)
    sse = float(((o - r) ** 2).sum())
    if sse == 0:
        return 999.99
    maxv = (1 << bit_depth) - 1
    return 10.0 * math.log10(maxv * maxv * o.size / sse)


class Analyze:
    """Accumulates bits + per-component PSNR per slice type and prints the
    reference-style summary block."""

    _NAMES = {2: "I", 1: "P", 0: "B"}

    def __init__(self, fps=30.0):
        self.fps = fps
        self.acc = {}   # slice_type -> [count, bits, psnrY, psnrU, psnrV]

    def add_picture(self, slice_type, bits, orig_planes, recon_planes,
                    bit_depth):
        e = self.acc.setdefault(slice_type, [0, 0.0, 0.0, 0.0, 0.0])
        e[0] += 1
        e[1] += bits
        for c in range(min(3, len(orig_planes))):
            e[2 + c] += psnr(orig_planes[c], recon_planes[c], bit_depth)

    def _row(self, label, e):
        n = max(1, e[0])
        kbps = e[1] * self.fps / n / 1000.0
        return (f"{label:>10s} {e[0]:7d} a {kbps:12.4f} {e[2] / n:8.4f}"
                f" {e[3] / n:8.4f} {e[4] / n:8.4f}")

    def summary(self):
        lines = []
        total = [0, 0.0, 0.0, 0.0, 0.0]
        for st in (2, 1, 0):
            if st not in self.acc:
                continue
            e = self.acc[st]
            for i in range(5):
                total[i] += e[i]
            lines.append(f"\n{self._NAMES[st]} Slices--------------------------------------------------------")
            lines.append("        Total Frames |   Bitrate     Y-PSNR   U-PSNR   V-PSNR")
            lines.append(self._row(self._NAMES[st], e))
        lines.append("\nSUMMARY --------------------------------------------------------")
        lines.append("        Total Frames |   Bitrate     Y-PSNR   U-PSNR   V-PSNR")
        lines.append(self._row("Total", total))
        return "\n".join(lines)
