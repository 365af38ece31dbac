"""The traced window's reading on a made-up trace: device busy time, the
window with the benchmark's generator cut out, and the idle gaps."""
import pytest

from harness import devtrace


class _Event:
    def __init__(self, name, cuda, start_us, dur_us):
        self._n, self._c = name, cuda
        self._s, self._d = start_us * 1000, dur_us * 1000

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._c else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


class _Prof:
    def __init__(self, events):
        class K:
            def __init__(self, ev):
                self._ev = ev

            def events(self):
                return self._ev

        class P:
            pass

        self.profiler = P()
        self.profiler.kineto_results = K(events)


def test_generator_is_cut_out_of_the_window():
    # generate 0-100 us, submit 100-300, run_for 300-600 with a kernel at
    # 350-450; generate again 600-700, submit 700-800
    prof = _Prof([
        _Event("bench.generate", False, 0, 100),
        _Event("bench.submit", False, 100, 200),
        _Event("bench.run_for", False, 300, 300),
        _Event("admit_small", True, 350, 100),
        _Event("bench.generate", False, 600, 100),
        _Event("bench.submit", False, 700, 100),
    ])
    rec = devtrace.read(prof)
    assert rec["traced_window_s"] == pytest.approx(600e-6)
    assert rec["busy_s"] == pytest.approx(100e-6)
    assert rec["kernels"] == {"admit_small": pytest.approx(100e-6)}
    gaps = sorted(rec["idle_gaps"], key=lambda g: -g[1])
    # 100-350 (submit, then run_for), 450-600 (run_for), 700-800 (submit)
    assert [g[1] for g in gaps] == pytest.approx([250e-6, 150e-6, 100e-6])
    assert {g[0] for g in gaps} <= {"submit", "run_for"}
