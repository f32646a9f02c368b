# Copied from libhm_tpu/hostdec/cabac.py
"""CABAC arithmetic decoding engine (Rec. H.265 9.3.4.3).

Rebuild of the reference's bin decoder (reference: source/Lib/TLibDecoder/
TDecBinCoderCABAC.cpp:68-300) using the spec's bit-oriented register
formulation, which is arithmetically identical to HM's byte-oriented one.
Contexts use the combined 7-bit state = (pStateIdx << 1) | valMps.

This Python engine is the correctness oracle; the throughput path is the C++
implementation in libhm_tpu/hostdec/native.
"""
from .tables import LPS_TABLE, NEXT_STATE_MPS, NEXT_STATE_LPS


class CabacDecoder:
    __slots__ = ("data", "pos", "nbits", "range", "offset")

    def __init__(self, data: bytes, start_bit: int = 0):
        """data: RBSP bytes; start_bit: byte-aligned bit offset of slice data."""
        assert start_bit % 8 == 0
        self.data = data
        self.pos = start_bit
        self.nbits = 8 * len(data)
        self.range = 510
        self.offset = self._read_bits(9)

    # -- raw bit feed (reads past the end return 0, as HM's readByte does) --
    def _read_bit(self) -> int:
        p = self.pos
        self.pos = p + 1
        if p >= self.nbits:
            return 0
        return (self.data[p >> 3] >> (7 - (p & 7))) & 1

    def _read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self._read_bit()
        return v

    # -- bin decoding ------------------------------------------------------
    def decode_bin(self, ctx, idx: int) -> int:
        """ctx: int32 numpy array of combined states; idx: context index."""
        state = ctx[idx]
        lps = int(LPS_TABLE[state >> 1, (self.range >> 6) & 3])
        self.range -= lps
        if self.offset >= self.range:
            binv = 1 - (state & 1)
            self.offset -= self.range
            self.range = lps
            ctx[idx] = NEXT_STATE_LPS[state]
        else:
            binv = state & 1
            ctx[idx] = NEXT_STATE_MPS[state]
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bit()
        return binv

    def decode_bypass(self) -> int:
        self.offset = (self.offset << 1) | self._read_bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def decode_bypass_bins(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.decode_bypass()
        return v

    def decode_terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bit()
        return 0

    def decode_eg_k(self, k: int) -> int:
        """Exp-Golomb order-k, bypass bins."""
        v = 0
        while self.decode_bypass():
            v += 1 << k
            k += 1
        while k:
            k -= 1
            if self.decode_bypass():
                v += 1 << k
        return v

    def align_range(self):
        """CABAC bypass alignment (RExt high-throughput): range := 256."""
        self.range = 256

    # -- state copy for WPP / dependent slices ------------------------------
    def save_engine(self):
        return (self.pos, self.range, self.offset)

    def load_engine(self, st):
        self.pos, self.range, self.offset = st
