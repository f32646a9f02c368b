"""sm_ms_per_picture (ms/picture, device trace): the time the card's
SMs spend on one delivered picture: the device time of every kernel the
trace holds for the window (the program's and PyTorch's), over the
pictures delivered.  Copies and memsets are not counted: they run on the
copy engines, beside the kernels.  With many streams a card, a card
delivers at most 1000 / sm_ms_per_picture pictures a second."""


def read(run):
    t = sum(op.t1 - op.t0 for op in run.ops if op.kind == "kernel")
    return 1e3 * t / run.pictures if run.pictures and t > 0 else None
