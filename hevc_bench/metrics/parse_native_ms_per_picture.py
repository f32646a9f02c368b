"""parse_native_ms_per_picture (ms/picture, program spans; host parse
layer): the C++ parse with its thread pool (the program's `parse.native`
spans, around hevcdec_decode in native_bridge.parse_stream) in the
window, over the pictures delivered."""
import program_spans


def read(run):
    return program_spans.ms_per_picture(run, "parse.native")
