# Copied from libhm_tpu/encoder/cabac_enc.py
"""CABAC arithmetic encoder + bit writer (Rec. H.265 9.3.4.4).

Rebuild of the reference's TEncBinCABAC (source/Lib/TLibEncoder/
TEncBinCoderCABAC.cpp) in the spec's low/range/outstanding-bits form.
Produces streams parseable by both our decoder and the HM reference binary.
"""
from ..hostdec.tables import LPS_TABLE, NEXT_STATE_MPS, NEXT_STATE_LPS


class BitWriter:
    """MSB-first bit writer over a bytearray."""

    def __init__(self):
        self.buf = bytearray()
        self.cur = 0
        self.nbits = 0

    def put(self, bit):
        self.cur = (self.cur << 1) | (bit & 1)
        self.nbits += 1
        if self.nbits == 8:
            self.buf.append(self.cur)
            self.cur = 0
            self.nbits = 0

    def put_bits(self, val, n):
        for i in range(n - 1, -1, -1):
            self.put((val >> i) & 1)

    def ue(self, v):
        v += 1
        n = v.bit_length()
        self.put_bits(0, n - 1)
        self.put_bits(v, n)

    def se(self, v):
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def byte_align_one(self):
        """rbsp/byte alignment: one 1-bit then zero pad."""
        self.put(1)
        while self.nbits:
            self.put(0)

    def align_zero(self):
        while self.nbits:
            self.put(0)

    def data(self):
        assert self.nbits == 0
        return bytes(self.buf)


class CabacEncoder:
    """Arithmetic encoder writing into a BitWriter."""

    def __init__(self, bw: BitWriter):
        self.bw = bw
        self.low = 0
        self.range = 510
        self.bits_outstanding = 0
        self.first_bit = True

    def _put(self, b):
        if self.first_bit:
            self.first_bit = False
        else:
            self.bw.put(b)
        while self.bits_outstanding:
            self.bw.put(1 - b)
            self.bits_outstanding -= 1

    def _renorm(self):
        while self.range < 256:
            if self.low < 256:
                self._put(0)
            elif self.low >= 512:
                self._put(1)
                self.low -= 512
            else:
                self.bits_outstanding += 1
                self.low -= 256
            self.low <<= 1
            self.range <<= 1

    def encode_bin(self, ctx, idx, binval):
        state = int(ctx[idx])
        lps = int(LPS_TABLE[state >> 1, (self.range >> 6) & 3])
        self.range -= lps
        if binval != (state & 1):
            self.low += self.range
            self.range = lps
            ctx[idx] = NEXT_STATE_LPS[state]
        else:
            ctx[idx] = NEXT_STATE_MPS[state]
        self._renorm()

    def encode_bypass(self, binval):
        self.low <<= 1
        if binval:
            self.low += self.range
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.bits_outstanding += 1
            self.low -= 512

    def encode_bypass_bins(self, val, n):
        for i in range(n - 1, -1, -1):
            self.encode_bypass((val >> i) & 1)

    def encode_terminate(self, binval):
        self.range -= 2
        if binval:
            self.low += self.range
            self._flush()
        else:
            self._renorm()

    def _flush(self):
        self.range = 2
        self._renorm()
        self._put((self.low >> 9) & 1)
        self.bw.put_bits(((self.low >> 7) & 3) | 1, 2)

    def pcm_payload(self, bits):
        """Raw PCM samples after a terminate(1) flush: byte-align, write
        the (value, nbits) list, then reinitialise the arithmetic engine
        (reference TEncSbac::codeIPCMInfo + xWritePCMCode + resetBac)."""
        self.bw.align_zero()
        for v, n in bits:
            self.bw.put_bits(int(v), n)
        self.low = 0
        self.range = 510
        self.bits_outstanding = 0
        self.first_bit = True

    def encode_eg_k(self, v, k):
        """Exp-Golomb order-k via bypass bins (inverse of decode_eg_k)."""
        while v >= (1 << k):
            self.encode_bypass(1)
            v -= 1 << k
            k += 1
        self.encode_bypass(0)
        while k:
            k -= 1
            self.encode_bypass((v >> k) & 1)


# ---------------------------------------------------------------------------
# Adaptive CABAC init-table selection (reference TEncSbac::determineCabacInitIdx,
# TEncSbac.cpp:167-226 + ContextModel3DBuffer::calcCost).  HM keeps
# cabac_init_present_flag always on (TEncTop.cpp:761) and, after encoding
# each P/B slice, prices the B- and P-init tables against the slice's
# final context states: for every context that actually coded bins, the
# expected bits of its empirical bin distribution under the candidate
# init state are accumulated, and the cheaper table initialises the NEXT
# slice (cabac_init_flag signals when it differs from the slice's own
# type).  The probability/entropy tables are generated from the CABAC
# state model (p_LPS(s) = 0.5 * alpha^s, alpha = (0.01875/0.5)^(1/63)),
# not copied from the reference.
#
# The per-state bit costs model the REAL renormalized arithmetic coder
# (the reference's corrected FAST_BIT_EST table,
# ContextModel.cpp:106-118): coding a symbol that shrinks the 9-bit
# range R to R' costs log2(R/R') bits, averaged over the coder's
# asymptotic range distribution, which is log-uniform (density 1/R on
# [256,510]).  This reproduces the reference table to within 0.0015 bit
# per entry (vs up to 1.75 bits off for the pure -log2(p) state model at
# confident states, which could flip init-table choices).
import math as _math

_ALPHA = (0.01875 / 0.5) ** (1.0 / 63.0)
_PROB_LPS = [0.5 * _ALPHA ** i for i in range(64)]


def _gen_entropy_bits():
    from ..hostdec.tables import LPS_TABLE
    mps, lps = [], []
    rs = range(256, 511)
    wsum = sum(1.0 / r for r in rs)
    for s in range(64):
        em = el = 0.0
        for r in rs:
            w = (1.0 / r) / wsum
            rl = int(LPS_TABLE[s][(r >> 6) & 3])
            em += w * _math.log2(r / (r - rl))
            el += w * _math.log2(r / rl)
        mps.append(em * 32768.0)
        lps.append(el * 32768.0)
    return mps, lps


_EBITS_MPS, _EBITS_LPS = _gen_entropy_bits()


def determine_cabac_init_idx(bank, bins_coded, qp):
    """Return the cheaper init table type (0=B, 1=P) for the next slice.

    bank: the final adapted context bank of the slice just coded.
    bins_coded: {bank_key: int array} counts of bins actually coded per
    context (contexts with zero bins contribute no cost, as in the
    reference's ContextModel::getBinsCoded() gate).
    """
    from ..hostdec.tables import INIT_VALUES, ctx_init_state
    best_cost, best_type = None, 0
    for cand in (0, 1):                      # {B_SLICE, P_SLICE}, tie -> B
        cost = 0
        for name, arr in bank.items():
            rows = INIT_VALUES.get(
                "last" if name in ("last_x", "last_y") else name)
            used = bins_coded.get(name)
            if rows is None or used is None:
                continue
            init_row = rows[cand]
            for i in range(len(arr)):
                if used[i] <= 0:
                    continue
                cur = int(arr[i])
                plps = _PROB_LPS[cur >> 1]
                if cur & 1:
                    p0, p1 = plps, 1.0 - plps
                else:
                    p0, p1 = 1.0 - plps, plps
                cnd = ctx_init_state(init_row[i], qp)
                cs = cnd >> 1
                if cnd & 1:                  # candidate MPS = 1
                    eb0, eb1 = _EBITS_LPS[cs], _EBITS_MPS[cs]
                else:
                    eb0, eb1 = _EBITS_MPS[cs], _EBITS_LPS[cs]
                # per-context UInt truncation mirrors the reference sum
                cost += int(p0 * eb0 + p1 * eb1)
        if best_cost is None or cost < best_cost:
            best_cost, best_type = cost, cand
    return best_type
