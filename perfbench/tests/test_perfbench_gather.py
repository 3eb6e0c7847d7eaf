"""The reader of gather_op_list_pct.seq on hand-set counts of
graph.program.GLSL_GATHER_RUNS."""

import pytest

from perfbench import harness
from perfbench.harness import Record


@pytest.fixture
def runs(monkeypatch):
    from reforge_tpu_torch.graph import program

    def put(counts):
        if counts is None:
            monkeypatch.delattr(program, "GLSL_GATHER_RUNS", raising=False)
        else:
            monkeypatch.setattr(program, "GLSL_GATHER_RUNS", counts, raising=False)

    return put


def test_the_share_of_runs_on_op_lists(runs):
    read = harness.reader("gather_op_list_pct.seq").read
    runs({"op_list": 96, "interpreter": 0})
    assert read(Record(loop="sequence")) == pytest.approx(100.0)
    runs({"op_list": 24, "interpreter": 72})
    assert read(Record(loop="sequence")) == pytest.approx(25.0)
    runs({"op_list": 0, "interpreter": 96})
    assert read(Record(loop="sequence")) == pytest.approx(0.0)
    assert read(Record(loop="live")) is None


def test_nothing_to_read_reads_none(runs):
    read = harness.reader("gather_op_list_pct.seq").read
    runs({"op_list": 0, "interpreter": 0})  # no such node ran
    assert read(Record(loop="sequence")) is None
    runs(None)  # a program without the counter (the parent of this metric)
    assert read(Record(loop="sequence")) is None
