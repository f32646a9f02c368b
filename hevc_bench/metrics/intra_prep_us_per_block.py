"""intra_prep_us_per_block (us/block, program spans and counter; host
prep layer): self time of the program's `prep.intra` spans (intra_table
with prepare_component, once per component of a DAG level) in the
window, over the intra blocks they count."""
import program_spans


def read(run):
    return program_spans.us_per_item(run, "prep.intra")
