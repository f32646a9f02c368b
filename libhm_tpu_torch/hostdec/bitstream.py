# Copied from libhm_tpu/hostdec/bitstream.py
"""RBSP bit reader for HEVC syntax parsing.

TPU-native rebuild of the reference's input bitstream layer
(reference: source/Lib/TLibCommon/TComBitStream.cpp:165-217 and
source/Lib/TLibDecoder/SyntaxElementParser.cpp) — re-designed as a plain
Python reader over a bytes object; the production fast path lives in the
C++ host library (libhm_tpu/hostdec/native).
"""


def strip_emulation_prevention(data: bytes) -> bytes:
    """EBSP -> RBSP: remove emulation_prevention_three_byte (00 00 03).

    Mirrors behavior of reference source/Lib/TLibDecoder/NALread.cpp:55.
    The reference's sequential zero-counter is equivalent to a local test:
    a 0x03 is removed iff it is preceded by a zero-run of length exactly 2
    (the counter enters every zero-run at 0 because both nonzero bytes and
    removed 0x03s reset it), so this vectorizes.
    """
    n = len(data)
    if n < 3:
        return bytes(data)
    import numpy as np
    d = np.frombuffer(data, np.uint8)
    cand = (d[2:] == 3) & (d[1:-1] == 0) & (d[:-2] == 0)
    if not cand.any():
        return bytes(data)
    rm = np.zeros(n, bool)
    rm[2:] = cand
    rm[3:] &= d[:-3] != 0  # zero-run longer than 2 -> counter != 2 -> keep
    return d[~rm].tobytes()


def strip_emulation_prevention_pos(data: bytes):
    """EBSP -> (RBSP, epb_positions).

    epb_positions[i] is the RBSP byte index immediately FOLLOWING the i-th
    removed emulation byte — what the slice-header entry-point adjustment
    needs (Rec. 7.4.7.1: entry point offsets count EBSP bytes; the
    reference subtracts located emulation bytes, TDecCAVLC parseSliceHeader).
    """
    n = len(data)
    import numpy as np
    if n < 3:
        return bytes(data), []
    d = np.frombuffer(data, np.uint8)
    cand = (d[2:] == 3) & (d[1:-1] == 0) & (d[:-2] == 0)
    if not cand.any():
        return bytes(data), []
    rm = np.zeros(n, bool)
    rm[2:] = cand
    rm[3:] &= d[:-3] != 0
    removed = np.nonzero(rm)[0]
    positions = (removed - np.arange(len(removed))).tolist()
    return d[~rm].tobytes(), positions


class BitReader:
    """MSB-first bit reader over RBSP bytes."""

    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position
        self.nbits = 8 * len(data)

    def u(self, n: int) -> int:
        """Read n bits as unsigned int (f(n)/u(n))."""
        v = 0
        pos = self.pos
        if pos + n > self.nbits:
            raise EOFError("bitstream overrun")
        data = self.data
        for _ in range(n):
            v = (v << 1) | ((data[pos >> 3] >> (7 - (pos & 7))) & 1)
            pos += 1
        self.pos = pos
        return v

    def flag(self) -> int:
        pos = self.pos
        if pos >= self.nbits:
            raise EOFError("bitstream overrun")
        self.pos = pos + 1
        return (self.data[pos >> 3] >> (7 - (pos & 7))) & 1

    def ue(self) -> int:
        """Exp-Golomb unsigned (ue(v))."""
        zeros = 0
        while self.flag() == 0:
            zeros += 1
            if zeros > 32:
                raise ValueError("bad ue(v)")
        if zeros == 0:
            return 0
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self) -> int:
        """Exp-Golomb signed (se(v))."""
        k = self.ue()
        return (k + 1) >> 1 if (k & 1) else -(k >> 1)

    def byte_align(self):
        self.pos = (self.pos + 7) & ~7

    def is_byte_aligned(self) -> bool:
        return (self.pos & 7) == 0

    def bits_left(self) -> int:
        return self.nbits - self.pos

    def more_rbsp_data(self) -> bool:
        """True if there is RBSP payload before the rbsp_stop_one_bit."""
        if self.pos >= self.nbits:
            return False
        # The final one-bit in the stream is the rbsp_stop_one_bit; payload
        # remains iff the current position is before it.
        last = self.nbits - 1
        while last >= self.pos:
            if (self.data[last >> 3] >> (7 - (last & 7))) & 1:
                break
            last -= 1
        return self.pos < last
