"""host_prep_ms_per_picture (ms/picture, program spans; host prep layer):
self time of the spans that build the kernels' tables on the host
(prepare_component, residual_tables, intra_table, level_maps,
_inter_level_*), less the uploads and launches made inside them, over
the pictures delivered."""
import spans


def read(run):
    if not run.pictures or not any(s.name in spans.HOST_PREP
                                   for s in run.spans):
        return None
    return 1e3 * spans.self_seconds(run.spans, spans.HOST_PREP) / run.pictures
