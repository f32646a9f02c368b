"""parser_load_s (s, program span; set-up layer): the program's
`parser.load` span, closed before the window: native_bridge._load's
first call (the build check, _pick_variant timing the parser's two
builds in subprocesses, the library's load)."""
import program_spans


def read(run):
    return program_spans.seconds_before(run, "parser.load")
