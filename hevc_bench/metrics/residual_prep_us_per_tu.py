"""residual_prep_us_per_tu (us/TU, program spans and counter; host prep
layer): self time of the program's `prep.residual` spans
(residual_tables, once per DAG level) in the window, over the TUs they
count."""
import program_spans


def read(run):
    return program_spans.us_per_item(run, "prep.residual")
