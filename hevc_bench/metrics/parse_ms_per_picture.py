"""parse_ms_per_picture (ms/picture, program spans; host parse layer):
self time of the whole-file parse (Decoder.decode_annexb) over the
pictures delivered."""
import spans


def read(run):
    if not run.pictures or not any(s.name in spans.PARSE for s in run.spans):
        return None
    return 1e3 * spans.self_seconds(run.spans, spans.PARSE) / run.pictures
