"""The comparison that decides `correct` fails where it must.

The control: the same delivered files judged after every sample is
rounded to 8 bits (the nearest precision below the configurations' 10)
reads every file wrong, on three seeds, where the program reads none.
The faults: a run with the timed path broken underneath comes out not
correct, for each fault a cell of this benchmark can have: a step that
returns its state unchanged (the loop filter hands its planes back
unfiltered), half of the pictures left out, and a sample altered where
the picture is produced (the download).  A cell on one chip has no
exchange between chips to leave out.  At 416x240 on the CPU; on the card
at the cells' own size: `python3 hevc_bench/control.py`.
"""
import numpy as np
import pytest

from conftest import CELLS, run_small, small_spec
import control
import reference


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell):
    spec = small_spec(cell)
    out = control.readings(spec, [2 ** 31 + 1, 7, 2 ** 40 + 3], 0.1, "cpu",
                           0.0)
    for seed, program, ctrl, pictures in out:
        assert pictures > 0
        assert program == {"files_wrong": 0, "pictures_missing": 0}
        assert reference.within_limits(program)
        assert ctrl["files_wrong"] >= 1
        assert not reference.within_limits(ctrl)


def test_to_8_bits():
    a = np.array([0, 1, 2, 3, 4, 6, 1021, 1022, 1023], np.uint16)
    assert reference.to_8_bits(a, 10).tolist() == [0, 0, 4, 4, 4, 8, 1020,
                                                   1020, 1020]


def _loop_filter_unchanged(monkeypatch):
    from libhm_tpu_torch.ops import loopfilter
    monkeypatch.setattr(loopfilter, "loop_filter_level",
                        lambda stacked, mb, **kw: stacked)


def _half_left_out(monkeypatch):
    from libhm_tpu_torch.parallel import dag_decode
    batch = dag_decode.decode_batch
    monkeypatch.setattr(dag_decode, "decode_batch",
                        lambda data, **kw: batch(data, **kw)[::2])


def _sample_altered(monkeypatch):
    from libhm_tpu_torch.parallel import dag_decode
    download = dag_decode._download

    def altered(small):
        planes = download(small)
        planes[0][5, 7] ^= 1
        return planes
    monkeypatch.setattr(dag_decode, "_download", altered)


FAULTS = {"state_unchanged": _loop_filter_unchanged,
          "half_left_out": _half_left_out,
          "sample_altered": _sample_altered}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_faults_come_out_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    line, checks, _ = run_small(small_spec(cell))
    assert line["correct"] is False
    assert line["failed"] >= 1 or checks["pictures_missing"]["value"] > 0
