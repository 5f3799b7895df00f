"""The trace reduction (union of intervals, attribution of device work to
the host range that launched it, idle gaps) and each metric reader, on a
small recorded trace."""

import pytest
from torch.autograd import DeviceType

from lsr_bench import harness, trace

from conftest import LATER


class Ev:
    def __init__(self, name, dev, s, e, corr=0, link=0, tid=1, idx=0, annot=False):
        self._v = (name, dev, s, e, corr, link, tid, idx, annot)

    def name(self): return self._v[0]
    def device_type(self): return self._v[1]
    def start_ns(self): return self._v[2]
    def end_ns(self): return self._v[3]
    def duration_ns(self): return self._v[3] - self._v[2]
    def correlation_id(self): return self._v[4]
    def linked_correlation_id(self): return self._v[5]
    def start_thread_id(self): return self._v[6]
    def device_index(self): return self._v[7]
    def is_user_annotation(self): return self._v[8]


CPU, GPU = DeviceType.CPU, DeviceType.CUDA
EVENTS = [
    Ev("lsr.step", CPU, 0, 500, corr=1), Ev("lsr.head", CPU, 100, 200, corr=2),
    Ev("aten::mm", CPU, 150, 160, corr=10), Ev("aten::add", CPU, 300, 310, corr=11),
    Ev("aten::copy_", CPU, 600, 610, corr=12),
    Ev("kernel_a", GPU, 150, 350, link=10), Ev("kernel_b", GPU, 300, 400, link=11),
    Ev("Memcpy PtoP (Device -> Device)", GPU, 620, 700, link=12, idx=1),
    Ev("lsr.step", GPU, 0, 500, annot=True),
]


@pytest.fixture
def tr():
    return trace.read_events(EVENTS, 0, 1000, [0, 1], 1000e-9)


def test_union_length():
    assert trace.union_length([(0, 10), (5, 20), (30, 40)], 0, 100)[0] == 30
    assert trace.union_length([(0, 10), (5, 20), (30, 40)], 8, 35)[0] == 17
    assert trace.union_length([], 0, 10) == (0, [])


def test_busy_ops_ranges_and_idle(tr):
    assert tr.busy_s == {0: 250e-9, 1: 80e-9}
    assert tr.n_ops == 3
    assert tr.range_device_s == {"head": 200e-9, "step": 250e-9}
    assert tr.range_ops == {"head": 1, "step": 2}
    # dev 0 idle [0,150) and [400,1000), dev 1 [0,620) and [700,1000): a gap
    # goes to the range open when it starts
    assert tr.idle_by_range["step"] == pytest.approx((150 + 600 + 620) * 1e-9)
    assert tr.idle_by_range["outside_ranges"] == pytest.approx(300e-9)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["kernel_a", 200e-9] and len(bd["idle_gaps"]) == 2


def test_readers_on_a_recorded_run(tr):
    cell = harness.load_cell("mini-train", more=LATER)
    cell.chips = 4

    class D:
        m = {"vocab_size": 10, "hidden_size": 4}

        class head:
            @staticmethod
            def bytes(V, train):
                return 3.35e12 * 100e-9  # 100 ns at the HBM peak

    first = harness.Half(2.0, [{"steps": 1, "flops": 989e12 * 0.04, "docs": 180}])
    second = harness.Half(1.0, [{"steps": 2, "data_s": 0.004, "head_flops": 989e12 * 50e-9,
                                 "calls": 2, "queries": 128, "escalated": 32}])
    run = harness.Run(cell, D(), first, second, tr)

    def read(name):
        return harness.load_reader(harness.BENCH_DIR, name)(run)

    assert read("train_mfu") == pytest.approx(100 * 0.04 / 2.0 / 4)  # four cards
    assert read("data_ms_per_step.train") == pytest.approx(2.0)
    assert read("device_ops_per_step.train") == pytest.approx(1.5)
    assert read("device_ops_per_call.search") == pytest.approx(1.5)
    assert read("idle_share.train") == pytest.approx(100 * (1 - 165e-9 / 1000e-9))
    assert read("certified_share.search") == pytest.approx(75.0)
    assert read("head_roofline.train") == pytest.approx(100 * 100e-9 / 200e-9)  # bytes bound
    run.trace = None
    for name in ("device_ops_per_step.train", "head_roofline.ingest", "idle_share.search"):
        assert read(name) is None  # nothing to read: no number, never 0


def test_open_ranges_finds_a_range_around_many_nested_ones():
    ranges = [(0, 1000, "outer")] + [(10 * i, 10 * i + 5, "inner") for i in range(1, 60)]
    got = trace.open_ranges(ranges, [992, 12, 1001, 0])
    assert got == [["outer"], ["outer", "inner"], [], ["outer"]]
