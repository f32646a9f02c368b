# Copied from libhm_tpu/utils/trace.py
"""ENC_DEC_TRACE-equivalent symbol tracing + diff.

The reference's de-facto integration test is the encoder/decoder CABAC
symbol trace with a global counter (reference: TComRom.h:178-200
g_hTrace/g_nSymbolCounter, DTRACE_CABAC_* at every parse/write site) —
diffing TraceEnc vs TraceDec localizes the first mismatching syntax
element.  This module provides the same capability first-party:

    HEVC_TRACE=/tmp/dec.txt python -m libhm_tpu.apps.dec_app ...   # decode
    enable_encoder_trace("/tmp/enc.txt")                           # encode
    python -m libhm_tpu.utils.trace enc.txt dec.txt                # diff

Each traced symbol is one line: `<counter> <kind> <value> <range>` where
kind is b (context bin), p (bypass), t (terminate).  The engine range
after the symbol is included so desyncs surface immediately even when the
bin values coincide.
"""
import os
import sys


class _Tracer:
    def __init__(self, path):
        # line-buffered: without a detach() the interpreter may drop the
        # tail of the trace on exit, which reads as a phantom divergence
        self.f = open(path, "w", buffering=1)
        self.n = 0

    def emit(self, kind, value, rng):
        self.f.write(f"{self.n} {kind} {value} {rng}\n")
        self.n += 1

    def close(self):
        self.f.close()


def attach_decoder_tracer(dec_cls, path):
    """Wrap CabacDecoder methods to trace every symbol (class-level)."""
    tr = _Tracer(path)
    orig_bin = dec_cls.decode_bin
    orig_byp = dec_cls.decode_bypass
    orig_term = dec_cls.decode_terminate

    def decode_bin(self, ctx, idx):
        v = orig_bin(self, ctx, idx)
        tr.emit("b", v, self.range)
        return v

    def decode_bypass(self):
        v = orig_byp(self)
        tr.emit("p", v, self.range)
        return v

    def decode_terminate(self):
        v = orig_term(self)
        tr.emit("t", v, "-")  # post-terminate range differs enc/dec by design
        return v

    dec_cls.decode_bin = decode_bin
    dec_cls.decode_bypass = decode_bypass
    dec_cls.decode_terminate = decode_terminate

    def detach():
        dec_cls.decode_bin = orig_bin
        dec_cls.decode_bypass = orig_byp
        dec_cls.decode_terminate = orig_term
        tr.close()
    return detach


def attach_encoder_tracer(enc_cls, path):
    """Wrap CabacEncoder methods to trace every symbol (class-level)."""
    tr = _Tracer(path)
    orig_bin = enc_cls.encode_bin
    orig_byp = enc_cls.encode_bypass
    orig_term = enc_cls.encode_terminate

    def encode_bin(self, ctx, idx, v):
        orig_bin(self, ctx, idx, v)
        tr.emit("b", v, self.range)

    def encode_bypass(self, v):
        orig_byp(self, v)
        tr.emit("p", v, self.range)

    def encode_terminate(self, v):
        orig_term(self, v)
        tr.emit("t", v, "-")  # post-terminate range differs enc/dec by design

    enc_cls.encode_bin = encode_bin
    enc_cls.encode_bypass = encode_bypass
    enc_cls.encode_terminate = encode_terminate

    def detach():
        enc_cls.encode_bin = orig_bin
        enc_cls.encode_bypass = orig_byp
        enc_cls.encode_terminate = orig_term
        tr.close()
    return detach


def maybe_enable_decoder_trace():
    """Called by the decode path when HEVC_TRACE is set."""
    path = os.environ.get("HEVC_TRACE")
    if not path:
        return None
    from ..hostdec.cabac import CabacDecoder
    return attach_decoder_tracer(CabacDecoder, path)


def diff_traces(path_a, path_b):
    """Returns (line_no, line_a, line_b) of the first divergence or None."""
    with open(path_a) as fa, open(path_b) as fb:
        n = 0
        while True:
            la = fa.readline()
            lb = fb.readline()
            if not la and not lb:
                return None
            if la.rstrip("\n") != lb.rstrip("\n"):
                return (n, la.rstrip("\n"), lb.rstrip("\n"))
            n += 1


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print("usage: python -m libhm_tpu_torch.utils.trace <traceA> <traceB>")
        return 2
    d = diff_traces(argv[0], argv[1])
    if d is None:
        print("traces identical")
        return 0
    n, la, lb = d
    print(f"first divergence at symbol {n}:")
    print(f"  A: {la or '<eof>'}")
    print(f"  B: {lb or '<eof>'}")
    return 1


if __name__ == "__main__":
    sys.exit(main())
