"""setup_s (s, host clock): from the start of run.py to the end of the
warm-up: imports, the program's builds where stale, the card, the
warm-up decode."""


def read(run):
    return run.setup_s
