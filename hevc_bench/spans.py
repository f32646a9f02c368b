"""Spans at the program's layer boundaries, recorded from outside it.

For a traced run the harness wraps, at run time, the functions of
libhm_tpu_torch listed in TARGETS; the program's files are not edited.
Each call of a wrapped function records a Span: its name, its start and
end on time.perf_counter(), and its self time (its duration less that of
the wrapped calls made inside it, on the same thread).  `unwrap` puts
every function back.

A target that the program no longer has is reported in `missing`, and the
metrics that read it read less: the table, not the program, is what a
later change of the program's layout has to update.
"""
import functools
import importlib
import threading
import time
from collections import namedtuple

Span = namedtuple("Span", "name t0 t1 self_s depth")

# (module, attribute path, span name).  The name "launch" is suffixed with
# the kernel's entry point (Kernel.name).
TARGETS = [
    # host parse of the whole file
    ("libhm_tpu_torch.hostdec.decoder", "Decoder.decode_annexb", "parse"),
    # reconstruction on the device, and the download of its pictures
    ("libhm_tpu_torch.parallel.dag_decode", "_recon_levels", "recon"),
    ("libhm_tpu_torch.parallel.dag_decode", "_materialize", "download"),
    ("libhm_tpu_torch.parallel.dag_decode", "_download", "download"),
    # host preparation of the kernels' tables
    ("libhm_tpu_torch.parallel.batch_decode", "prepare_component",
     "prepare_component"),
    ("libhm_tpu_torch.parallel.batch_decode", "residual_tables",
     "residual_tables"),
    ("libhm_tpu_torch.parallel.batch_decode", "intra_table", "intra_table"),
    ("libhm_tpu_torch.parallel.device_filters", "level_maps", "level_maps"),
    ("libhm_tpu_torch.parallel.dag_decode", "_inter_level_grid",
     "_inter_level_grid"),
    ("libhm_tpu_torch.parallel.dag_decode", "_inter_level_gathered",
     "_inter_level_gathered"),
    # transfers and launches
    ("libhm_tpu_torch.utils.xfer", "up", "upload"),
    ("libhm_tpu_torch.kernels.build", "Kernel.__call__", "launch"),
]

PARSE = ("parse",)
HOST_PREP = ("prepare_component", "residual_tables", "intra_table",
             "level_maps", "_inter_level_grid", "_inter_level_gathered")


class Recorder:
    def __init__(self):
        self.spans = []
        self.missing = []
        self._local = threading.local()
        self._patched = []
        for module, path, name in TARGETS:
            self._wrap(module, path, name)

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _wrap(self, module, path, name):
        try:
            owner = importlib.import_module(module)
            *outer, attr = path.split(".")
            for part in outer:
                owner = getattr(owner, part)
            fn = owner.__dict__[attr] if isinstance(owner, type) else \
                getattr(owner, attr)
        except (ImportError, AttributeError, KeyError):
            self.missing.append(f"{module}.{path}")
            return
        launch = name == "launch"
        rec = self

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            stack = rec._stack()
            frame = [0.0]
            stack.append(frame)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                t1 = time.perf_counter()
                stack.pop()
                if stack:
                    stack[-1][0] += t1 - t0
                label = f"launch:{args[0].name}" if launch else name
                rec.spans.append(Span(label, t0, t1, t1 - t0 - frame[0],
                                      len(stack)))

        self._patched.append((owner, attr, fn))
        setattr(owner, attr, wrapper)

    def unwrap(self):
        for owner, attr, fn in reversed(self._patched):
            setattr(owner, attr, fn)
        self._patched = []


def self_seconds(spans, names):
    """Summed self time of the spans called `names`."""
    return sum(s.self_s for s in spans if s.name in names)
