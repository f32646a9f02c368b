"""decode_fps_traced (pictures/s, host clock; whole-file entry layer):
every picture delivered to the caller in the traced window over the
window's seconds, from its start to the end of the request that was
running when it closed.  The wall rate users get, read in the --trace 1
run (spans and the profiler on, some 12% slower than untraced), since
the host's drifting pace keeps it from holding an end-to-end bound."""


def read(run):
    return run.pictures / run.window_s if run.window_s > 0 else None
