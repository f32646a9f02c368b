"""The yardstick's arithmetic: the loop filter's bytes from the picture
geometry, the roofline share against the published peak, the device's
busy and idle time from intervals, and the trace's clock moved onto the
host's by the marker."""
import pytest

import devtrace
import harness
import roofline
from spans import Span

HD10 = {"width": 1920, "height": 1080, "chroma_format": "420",
        "bit_depth": 10}


@pytest.mark.parametrize("geometry,pictures,nbytes", [
    # (1920*1080 + 2*960*540) samples x 2 bytes x (read + write)
    (HD10, 1, 12441600),
    (HD10, 3, 3 * 12441600),
    ({"width": 416, "height": 240, "chroma_format": "420", "bit_depth": 8},
     1, (416 * 240 + 2 * 208 * 120) * 1 * 2),
    ({"width": 1920, "height": 1080, "chroma_format": "444",
      "bit_depth": 16}, 2, 2 * 3 * 1920 * 1080 * 2 * 2),
    ({"width": 1920, "height": 1080, "chroma_format": "422",
      "bit_depth": 12}, 1, (1920 * 1080 + 2 * 960 * 1080) * 2 * 2),
    ({"width": 160, "height": 96, "chroma_format": "400", "bit_depth": 16},
     5, 5 * 160 * 96 * 2 * 2),
])
def test_loop_filter_bytes(geometry, pictures, nbytes):
    assert roofline.loop_filter_bytes(geometry, pictures) == nbytes


def test_share_of_the_published_peak():
    card = "NVIDIA H100 80GB HBM3"
    # 3.35e9 bytes in 1 ms is the peak; in 2 ms half of it
    assert roofline.share_pct(3.35e9, 1e-3, card) == pytest.approx(100.0)
    assert roofline.share_pct(3.35e9, 2e-3, card) == pytest.approx(50.0)
    assert roofline.share_pct(3.35e9, 0.0, card) is None
    assert roofline.share_pct(3.35e9, 1e-3, "some other card") is None


def test_busy_and_idle_from_intervals():
    ops = [(1.0, 2.0), (1.5, 2.5), (4.0, 4.5), (9.5, 11.0), (-1.0, 0.5)]
    assert devtrace.union(ops) == [(-1.0, 0.5), (1.0, 2.5), (4.0, 4.5),
                                   (9.5, 11.0)]
    assert devtrace.busy_seconds(ops, 0.0, 10.0) == pytest.approx(
        0.5 + 1.5 + 0.5 + 0.5)
    assert devtrace.gaps(ops, 0.0, 10.0) == [(0.5, 1.0), (2.5, 4.0),
                                             (4.5, 9.5)]
    spans = [Span("parse", 0.0, 3.0, 2.0, 0), Span("upload", 2.6, 3.5, 0.9,
                                                    1),
             Span("recon", 4.0, 9.0, 5.0, 0)]
    idle = devtrace.gaps(ops, 0.0, 10.0)
    assert devtrace.idle_by_host(idle, spans) == [
        ["recon", 5.0], ["upload", 1.5], ["parse", 0.5]]


def test_device_idle_pct_reader():
    reader = harness.load_module(
        harness.os.path.join(harness.os.path.dirname(devtrace.__file__),
                             "metrics", "device_idle_pct.py"), "idle")

    class R:
        ops = [devtrace.DeviceOp("k", "kernel", 1.0, 2.0),
               devtrace.DeviceOp("m", "memcpy", 1.5, 3.0)]
        t_start, t_end, window_s = 0.0, 10.0, 10.0

    assert reader.read(R) == pytest.approx(80.0)


def test_sm_ms_per_picture_reader():
    """Every kernel counts, the program's and PyTorch's; copies and
    memsets do not."""
    reader = harness.load_module(
        harness.os.path.join(harness.os.path.dirname(devtrace.__file__),
                             "metrics", "sm_ms_per_picture.py"), "sm")

    class R:
        ops = [devtrace.DeviceOp("intra_wavefront_kernel", "kernel", 1.0,
                                 1.004),
               devtrace.DeviceOp("vectorized_elementwise_kernel", "kernel",
                                 2.0, 2.002),
               devtrace.DeviceOp("Memcpy DtoH", "memcpy", 3.0, 3.5),
               devtrace.DeviceOp("Memset", "memset", 4.0, 4.1)]
        pictures = 3

    assert reader.read(R) == pytest.approx(2.0)
    R.pictures = 0
    assert reader.read(R) is None
    R.pictures, R.ops = 3, R.ops[2:]
    assert reader.read(R) is None


def test_trace_clock_moved_by_marker():
    trace = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": devtrace.MARK,
         "ts": 1000.0, "dur": 1.0},
        {"ph": "X", "cat": "kernel", "name": "void k<int>(P)",
         "ts": 3000.0, "dur": 500.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": 4000.0, "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::zeros",
         "ts": 1500.0, "dur": 10.0}]}
    ops = devtrace.device_ops(trace, mark_s=50.0)
    assert [(o.kind, o.name) for o in ops] == [("kernel", "void k<int>(P)"),
                                              ("memcpy", "Memcpy HtoD")]
    assert ops[0].t0 == pytest.approx(50.002)
    assert ops[0].t1 == pytest.approx(50.0025)


@pytest.mark.parametrize("name,base", [
    ("void (anonymous namespace)::loop_filter_kernel<int, true>(Params<int>)",
     "loop_filter_kernel"),
    ("void residual_table_kernel<short>(TuRow const*)",
     "residual_table_kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD"),
])
def test_kernel_names(name, base):
    assert devtrace.kernel_base(name) == base


def test_the_program_kernels_are_found():
    names = harness.port_kernel_names()
    assert {"loop_filter_kernel", "intra_wavefront_kernel",
            "residual_table_kernel", "mc_grid_kernel"} <= names
