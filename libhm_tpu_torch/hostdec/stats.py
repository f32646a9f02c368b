# Copied from libhm_tpu/hostdec/stats.py
"""Per-syntax-element CABAC statistics (reference TComCodingStatistics).

The reference gathers these only in the Analyser build
(RExt__DECODER_DEBUG_BIT_STATISTICS); here it is a wrapper that decodes a
stream with instrumented entropy calls and reports context-coded bin and
bypass-bin counts per syntax element, plus an estimated bit share.

    from libhm_tpu_torch.hostdec.stats import collect
    table = collect(open("stream.bin", "rb").read())

CLI: python -m libhm_tpu_torch.hostdec.stats <stream.bin>
"""
import sys
from collections import defaultdict


def collect(data: bytes, per_component=False):
    """Decode `data` (Annex-B) counting bins per syntax-element class.

    Returns {name: {"bins": n, "bypass": n}} plus "__total__".  With
    per_component, residual-coding elements split into ":c0" (luma) /
    ":c1" (chroma) rows — the attribution that localized the encoder's
    chroma allocation gap vs HM.
    """
    from . import cabac as cabac_mod
    from . import residual as res_mod
    from . import slicedec as sd_mod
    from .decoder import Decoder

    counts = defaultdict(lambda: {"bins": 0, "bypass": 0})
    cur_sd = [None]
    cur_name = [None]
    cur_comp = [None]

    orig_rc = res_mod.residual_coding
    orig_ds = sd_mod.SliceDecoder.decode_slice
    orig_bin = cabac_mod.CabacDecoder.decode_bin
    orig_byp = cabac_mod.CabacDecoder.decode_bypass
    orig_bypn = cabac_mod.CabacDecoder.decode_bypass_bins
    orig_eg = cabac_mod.CabacDecoder.decode_eg_k
    orig_trm = cabac_mod.CabacDecoder.decode_terminate

    def ds(self, *a, **k):
        cur_sd[0] = self
        return orig_ds(self, *a, **k)

    def rc(d, bank, w, h, comp, *a, **k):
        cur_comp[0] = comp
        try:
            return orig_rc(d, bank, w, h, comp, *a, **k)
        finally:
            cur_comp[0] = None

    _RES = ("sig", "sig_cg", "gt1", "gt2", "last_x", "last_y",
            "transform_skip", "rdpcm", "cu_transquant_bypass")

    def name_of(ctx):
        sd = cur_sd[0]
        if sd is not None:
            for k, v in sd.bank.items():
                if v is ctx:
                    if per_component and cur_comp[0] is not None \
                            and k in _RES:
                        return f"{k}:c{min(cur_comp[0], 1)}"
                    return k
        return "?"

    def d_bin(self, ctx, idx):
        nm = name_of(ctx)
        cur_name[0] = nm
        counts[nm]["bins"] += 1
        return orig_bin(self, ctx, idx)

    def d_byp(self):
        counts[cur_name[0] or "?"]["bypass"] += 1
        return orig_byp(self)

    def d_bypn(self, n):
        # orig_bypn dispatches to the PATCHED decode_bypass per bin, so
        # the inner hook does the counting (adding n here double-counts)
        return orig_bypn(self, n)

    def d_eg(self, k):
        # count inside via the patched bypass
        return orig_eg(self, k)

    def d_trm(self):
        counts["terminate"]["bins"] += 1
        return orig_trm(self)

    sd_mod.SliceDecoder.decode_slice = ds
    res_mod.residual_coding = rc
    sd_mod.residual_coding = rc
    cabac_mod.CabacDecoder.decode_bin = d_bin
    cabac_mod.CabacDecoder.decode_bypass = d_byp
    cabac_mod.CabacDecoder.decode_bypass_bins = d_bypn
    cabac_mod.CabacDecoder.decode_eg_k = d_eg
    cabac_mod.CabacDecoder.decode_terminate = d_trm
    try:
        Decoder().decode_annexb(data)
    finally:
        sd_mod.SliceDecoder.decode_slice = orig_ds
        res_mod.residual_coding = orig_rc
        sd_mod.residual_coding = orig_rc
        cabac_mod.CabacDecoder.decode_bin = orig_bin
        cabac_mod.CabacDecoder.decode_bypass = orig_byp
        cabac_mod.CabacDecoder.decode_bypass_bins = orig_bypn
        cabac_mod.CabacDecoder.decode_eg_k = orig_eg
        cabac_mod.CabacDecoder.decode_terminate = orig_trm

    total = {"bins": sum(v["bins"] for v in counts.values()),
             "bypass": sum(v["bypass"] for v in counts.values())}
    out = dict(counts)
    out["__total__"] = total
    return out


# ---------------------------------------------------------------------------
# Exact bit accounting (the Analyser build's TComCodingStatistics parity:
# reference TComCodingStatistics.h:47-141 counts actual bits per syntax
# element; here the engine's stream position delta around each symbol IS
# the exact consumed-bit count, and the NAL layer contributes start codes,
# NAL headers, emulation-prevention bytes and non-VCL payloads, so the
# grand total reconciles to the byte size of the stream exactly).
def collect_bits(data: bytes, per_component=False, per_tu_size=False):
    """Decode `data` (Annex-B) with EXACT per-syntax-element bit counts.

    Returns {category: bits} with NAL-layer categories
    (startcode/nal_header/emulation_prevention/non_vcl:*/slice_header/
    cabac_init_and_rounding) plus one row per syntax-element class; the
    values sum to len(data) * 8 exactly.
    """
    from . import cabac as cabac_mod
    from . import residual as res_mod
    from . import slicedec as sd_mod
    from .decoder import Decoder
    from . import nal as N

    bits = defaultdict(float)
    cur_sd = [None]
    cur_name = [None]
    cur_comp = [None]
    cur_size = [None]
    engines = []
    header_bits = [0]

    orig_init = cabac_mod.CabacDecoder.__init__
    orig_rc = res_mod.residual_coding
    orig_ds = sd_mod.SliceDecoder.decode_slice
    orig_bin = cabac_mod.CabacDecoder.decode_bin
    orig_byp = cabac_mod.CabacDecoder.decode_bypass
    orig_bypn = cabac_mod.CabacDecoder.decode_bypass_bins
    orig_trm = cabac_mod.CabacDecoder.decode_terminate

    def e_init(self, d, start_bit=0):
        orig_init(self, d, start_bit)
        engines.append(self)

    def ds(self, rbsp, sh, slice_idx):
        cur_sd[0] = self
        header_bits[0] += sh.data_bit_offset
        return orig_ds(self, rbsp, sh, slice_idx)

    def rc(d, bank, w, h, comp, *a, **k):
        cur_comp[0] = comp
        cur_size[0] = w
        try:
            return orig_rc(d, bank, w, h, comp, *a, **k)
        finally:
            cur_comp[0] = None
            cur_size[0] = None

    _RES = ("sig", "sig_cg", "gt1", "gt2", "last_x", "last_y",
            "transform_skip", "rdpcm", "cu_transquant_bypass")

    def name_of(ctx):
        sd = cur_sd[0]
        if sd is not None:
            for k, v in sd.bank.items():
                if v is ctx:
                    if k in _RES:
                        if per_tu_size and cur_size[0] is not None:
                            k = f"{k}:n{cur_size[0]}"
                        if per_component and cur_comp[0] is not None:
                            k = f"{k}:c{min(cur_comp[0], 1)}"
                    return k
        return "?"

    def d_bin(self, ctx, idx):
        nm = name_of(ctx)
        cur_name[0] = nm
        p0 = self.pos
        v = orig_bin(self, ctx, idx)
        bits[nm] += self.pos - p0
        return v

    def d_byp(self):
        v = orig_byp(self)
        bits[cur_name[0] or "?"] += 1
        return v

    def d_bypn(self, n):
        # inner patched decode_bypass records each bit (see collect())
        return orig_bypn(self, n)

    def d_trm(self):
        p0 = self.pos
        v = orig_trm(self)
        bits["terminate"] += self.pos - p0
        return v

    cabac_mod.CabacDecoder.__init__ = e_init
    sd_mod.SliceDecoder.decode_slice = ds
    res_mod.residual_coding = rc
    sd_mod.residual_coding = rc
    cabac_mod.CabacDecoder.decode_bin = d_bin
    cabac_mod.CabacDecoder.decode_bypass = d_byp
    cabac_mod.CabacDecoder.decode_bypass_bins = d_bypn
    cabac_mod.CabacDecoder.decode_terminate = d_trm
    try:
        Decoder().decode_annexb(data)
    finally:
        cabac_mod.CabacDecoder.__init__ = orig_init
        sd_mod.SliceDecoder.decode_slice = orig_ds
        res_mod.residual_coding = orig_rc
        sd_mod.residual_coding = orig_rc
        cabac_mod.CabacDecoder.decode_bin = orig_bin
        cabac_mod.CabacDecoder.decode_bypass = orig_byp
        cabac_mod.CabacDecoder.decode_bypass_bins = orig_bypn
        cabac_mod.CabacDecoder.decode_terminate = orig_trm

    # ---- NAL layer ----
    _NONVCL = {32: "vps", 33: "sps", 34: "pps", 35: "aud", 36: "eos",
               37: "eob", 38: "fd", 39: "sei", 40: "sei_suffix"}
    nal_payload_bits = 0
    vcl_rbsp_bits = 0
    for ebsp in N.split_annexb(data):
        nal_payload_bits += len(ebsp) * 8
        nu = N.parse_nal(ebsp)
        bits["nal_header"] += 16
        bits["emulation_prevention"] += 8 * len(nu.epb_positions)
        body = (len(ebsp) - 2 - len(nu.epb_positions)) * 8
        if nu.nal_type < 32:
            vcl_rbsp_bits += body
        else:
            bits["non_vcl:" + _NONVCL.get(nu.nal_type,
                                          str(nu.nal_type))] += body
    bits["startcode"] = len(data) * 8 - nal_payload_bits
    bits["slice_header"] = header_bits[0]

    # CABAC engine init (9-bit register preload per engine/substream) +
    # per-slice byte-alignment & rounding, reconciled so the table sums
    # to the stream size exactly (the reference books the same residue
    # under "CABAC_INITIALISATION-and-rounding")
    symbol_bits = sum(v for k, v in bits.items()
                      if k not in ("nal_header", "emulation_prevention",
                                   "slice_header", "startcode")
                      and not k.startswith("non_vcl:"))
    bits["cabac_init_and_rounding"] = \
        vcl_rbsp_bits - header_bits[0] - symbol_bits
    bits["__n_engines__"] = len(engines)
    bits["__total__"] = len(data) * 8
    return dict(bits)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 2
    if argv[0] == "--bits":
        per_tu = "--per-tu-size" in argv
        path = [a for a in argv[1:] if not a.startswith("--")][0]
        table = collect_bits(open(path, "rb").read(), per_component=True,
                             per_tu_size=per_tu)
        total = table.pop("__total__")
        table.pop("__n_engines__")
        print(f"{'category':32s} {'bits':>12s} {'share':>7s}")
        for name, v in sorted(table.items(), key=lambda kv: -kv[1]):
            print(f"{name:32s} {v:12.0f} {100.0 * v / total:6.2f}%")
        print(f"{'TOTAL (== stream bits)':32s} {total:12.0f}")
        return 0
    table = collect(open(argv[0], "rb").read(), per_component=True)
    total = table.pop("__total__")
    tot_all = max(1, total["bins"] + total["bypass"])
    print(f"{'syntax element':24s} {'ctx bins':>10s} {'bypass':>10s} {'share':>7s}")
    for name, v in sorted(table.items(),
                          key=lambda kv: -(kv[1]['bins'] + kv[1]['bypass'])):
        share = 100.0 * (v["bins"] + v["bypass"]) / tot_all
        print(f"{name:24s} {v['bins']:10d} {v['bypass']:10d} {share:6.2f}%")
    print(f"{'TOTAL':24s} {total['bins']:10d} {total['bypass']:10d}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
