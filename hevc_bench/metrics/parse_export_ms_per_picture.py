"""parse_export_ms_per_picture (ms/picture, program spans; host parse
layer): the Python export of the native parse, one object per TU, intra
block and PU (the program's `parse.export` spans, around the
native_bridge._materialize loop) in the window, over the pictures
delivered."""
import program_spans


def read(run):
    return program_spans.ms_per_picture(run, "parse.export")
