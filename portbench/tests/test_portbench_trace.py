"""The trace's reduction and the per-layer readers, on events made by hand:
busy time, the traced window, idle gaps by the runtime call that spans
them, kernel names by source file, and each reader's arithmetic."""

from __future__ import annotations

import pytest

from portbench import harness, spec, trace
from portbench.trace import HOST_CODE

# kernel names as torch.profiler gave them on the card
WALK = ("(anonymous namespace)::walk_kernel(int const*, int4 const*, int4 "
        "const*, int4 const*, uint2 const*, int*, int, int, int, int, int, "
        "int, float, float, float, int)")
KEYS = ("(anonymous namespace)::trial_keys_kernel(uint2*, unsigned int, "
        "unsigned int, unsigned int, int, int, int)")
K7 = ("void (anonymous namespace)::cdf_walk_bitmap_kernel<float, false>(int "
      "const*, int4 const*, int2 const*, int4 const*, int*, unsigned char*)")
K4 = ("void (anonymous namespace)::sgns_exact_step<4>(float*, float*, int "
      "const*, int const*, int const*)")
K12 = ("(anonymous namespace)::trainer_draws(long long const*, int, int, "
       "int, int, int)")
COPY = "Memcpy DtoH (Device -> Pageable)"


class _Ev:
    def __init__(self, name, start, dur, cuda):
        self._n, self._s, self._d, self._c = name, start, dur, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._c else "DeviceType.CPU"


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": lambda self: events})()})()


def _trace():
    ev = [
        _Ev("cudaLaunchKernel", 1000, 15, False),
        _Ev(KEYS, 1020, 20, True), _Ev(WALK, 1050, 400, True),
        _Ev("cudaMemcpyAsync", 1500, 700, False),
        _Ev(WALK, 2300, 300, True), _Ev(COPY, 2500, 200, True),
        _Ev("cudaStreamSynchronize", 2650, 350, False),
    ]
    return trace.summarize(_Prof(ev), 2)


def test_summarize_busy_window_and_gaps():
    tr = _trace()
    assert tr.calls == 2
    assert tr.window_s == pytest.approx(2000e-9)
    # [1020, 1040) + [1050, 1450) + [2300, 2700)
    assert tr.busy_s == pytest.approx((20 + 400 + 400) * 1e-9)
    gaps = tr.idle_gaps()
    assert gaps[0] == ("cudaMemcpyAsync", 850)
    assert gaps[1:] == [("cudaStreamSynchronize", 300),
                        ("cudaLaunchKernel", 20), (HOST_CODE, 10)]
    b = tr.breakdown()
    assert b["device_ops"][0] == [WALK, pytest.approx(700e-9)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_a_trace_without_device_operations_is_refused():
    with pytest.raises(RuntimeError, match="no device operation"):
        trace.summarize(_Prof([_Ev("cudaLaunchKernel", 0, 5, False)]), 1)


@pytest.mark.parametrize("source,hits,misses", [
    ("walk.cu", [WALK, KEYS], [K7, K4, K12, COPY]),
    ("cdf_walk.cu", [K7], [WALK, KEYS, K4]),
    ("sgns_exact.cu", [K4], [WALK, K7, K12, COPY]),
])
def test_kernels_are_found_by_their_source_file(source, hits, misses):
    pat = trace.source_pattern(source)
    assert all(pat.search(n) for n in hits)
    assert not any(pat.search(n) for n in misses)


class _Entry:
    def __init__(self, kind, sampler=None):
        self.kind, self.sampler, self.host_prep_s = kind, sampler, 1.5

    def bound_per_call(self, facts):
        return 1e-4 if self.kind == "walk" else 2e-3

    def work_per_call(self):
        return {"tokens": 100, "flops": 67e9}


def _read(name, entry, tr):
    view = harness.RunView(entry, tr, {"entries_per_call": 5}, 10, 4.0,
                           (8, 2.0))
    return spec.metric_reader(name)(view)


def test_readers_by_hand():
    tr = _trace()
    walk, cdf, train = (_Entry("walk", "rejection"), _Entry("walk", "cdf"),
                        _Entry("train"))
    walk_s = 720e-9
    assert _read("walk_roofline", walk, tr) == pytest.approx(
        100 * 1e-4 * 2 / walk_s)
    assert _read("train_mfu", train, tr) == pytest.approx(
        100 * 67e9 * 8 / 2.0 / 67e12)
    assert _read("host_prep_s", train, tr) == 1.5
    idle = 100 * (1 - 820 / 2000)
    assert _read("device_idle.walk", walk, tr) == pytest.approx(idle)
    assert _read("device_idle.train", train, tr) == pytest.approx(idle)
    # nothing to read: the other kind of cell, or no kernel of its source
    for name, entry in (("walk_roofline", cdf), ("cdf_roofline", walk),
                        ("cdf_roofline", cdf), ("k4_roofline", train),
                        ("k4_roofline", walk), ("train_mfu", walk),
                        ("device_idle.walk", train),
                        ("device_idle.train", walk)):
        assert _read(name, entry, tr) is None, name


def test_process_start_is_this_process_s():
    """A fresh process's start lies before its first statement's clock
    reading, and not long before it."""
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-c", "import time\nt = time.time()\n"
         "from portbench import harness\n"
         "print(t, harness.process_start())"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=120,
        check=True).stdout.split()
    if out[1] == "None":
        pytest.skip("no /proc here")
    first, start = float(out[0]), float(out[1])
    assert first - 5.0 < start <= first + 0.05
