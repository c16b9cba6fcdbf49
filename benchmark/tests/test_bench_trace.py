"""The trace reduction on synthetic traces: the window's ends, the busy
union, what counts as a kernel, and the idle gaps' labels."""

from torch.autograd import DeviceType

from harness import trace


class _Ev:
    """A kineto event as torch.profiler gives it (its methods that the
    reduction calls)."""

    def __init__(self, name, on_card, start, dur, annotation=False):
        self._n, self._c, self._s, self._d, self._a = name, on_card, start, dur, annotation

    def name(self):
        return self._n

    def device_type(self):
        return DeviceType.CUDA if self._c else DeviceType.CPU

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def is_user_annotation(self):
        return self._a


def _segment(with_span: bool):
    """A window from 0 to 10,000 ns; two kernels, a copy and a fill in it,
    the first two overlapping, and a kernel of earlier work before it; the
    host in `aten::where` over the first gap. With `with_span`, a
    record_function span around the work, which kineto mirrors on the card
    as a GPU user annotation of the same name."""
    ev = [_Ev("earlier_kernel", True, -500, 400),
          _Ev("aten::where", False, 50, 900),
          _Ev("cudaLaunchKernel", False, 800, 40),
          _Ev("where_kernel", True, 1000, 1000),
          _Ev("seed_select_compact_kernel", True, 1500, 1500),
          _Ev("Memcpy HtoD (Pinned -> Device)", True, 5000, 500),
          _Ev("Memset (Device)", True, 7000, 100)]
    if with_span:
        ev += [_Ev("mapquik.seed_batch", False, 900, 7000, annotation=True),
               _Ev("mapquik.seed_batch", True, 1000, 6100, annotation=True)]
    return ev


def test_window_busy_and_launches():
    for with_span in (False, True):
        tr = trace.reduce(_segment(with_span), 0, 10_000)
        assert tr.window_s == 10_000 / 1e9
        # [1000, 3000) + [5000, 5500) + [7000, 7100): the span's range adds nothing
        assert abs(tr.busy_s - 2600 / 1e9) < 1e-15
        assert tr.launches == 2 and tr.outside == 1
        assert tr.kernels("seed_select_compact") == [1500 / 1e9]
        assert {n for n, *_ in tr.device_ops} == {
            "where_kernel", "seed_select_compact_kernel", "Memcpy HtoD (Pinned -> Device)",
            "Memset (Device)"}


def test_idle_gaps_named_by_the_host():
    tr = trace.reduce(_segment(False), 0, 10_000)
    gaps = dict(tr.idle_gaps)
    assert abs(gaps["aten::where"] - 1000 / 1e9) < 1e-15        # [0, 1000)
    assert abs(gaps["host outside torch ops"] - 6400 / 1e9) < 1e-15
    b = trace.breakdown(tr)
    assert b["device_ops"][0][0] == "seed_select_compact_kernel"


def test_nothing_to_read():
    assert trace.reduce([_Ev("aten::mm", False, 0, 10)], 0, 100) is None
    assert trace.reduce([_Ev("late_kernel", True, 200, 10)], 0, 100) is None
