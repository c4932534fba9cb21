"""``utils/kernel_timing``'s trace reading on the CPU, with stand-in
torch.profiler key averages: a trace that misses a kernel is taken again,
and a kernel that no trace holds gives None rather than a time."""

from types import SimpleNamespace

import pytest

from srba_slam_tpu_torch.utils import kernel_timing as kt


def _ev(key, device="CUDA", us=0.0, count=1):
    return SimpleNamespace(key=key, device_type=SimpleNamespace(name=device),
                           self_device_time_total=us, count=count)


def _traces(monkeypatch, traces):
    calls = []

    def fake_profile_calls(fn, reps=1):
        calls.append(reps)
        return traces[len(calls) - 1]

    monkeypatch.setattr(kt, "profile_calls", fake_profile_calls)
    return calls


def test_profile_until_retakes_a_trace_that_misses_a_kernel(monkeypatch):
    missing = [_ev("cudaLaunchKernel", device="CPU"), _ev("orb_describe_kernel<uchar>", us=5.0)]
    full = [*missing, _ev("void fast_nms_kernel<uchar, 2>", us=9.0)]
    calls = _traces(monkeypatch, [missing, full])
    evs = kt.profile_until(lambda: None, ("fast_nms_kernel", "orb_describe_kernel"), reps=5)
    assert evs is full and calls == [5, 5]


def test_profile_until_gives_none_after_its_attempts(monkeypatch):
    cpu_only = [_ev("fast_nms_kernel", device="CPU")]
    calls = _traces(monkeypatch, [cpu_only] * kt.PROFILE_ATTEMPTS)
    assert kt.profile_until(lambda: None, ("fast_nms_kernel",)) is None
    assert len(calls) == kt.PROFILE_ATTEMPTS


@pytest.mark.parametrize("traced", [True, False])
def test_profiler_kernel_us_is_the_mean_or_none(monkeypatch, traced):
    hit = [_ev("fast_score_kernel<float, false>", us=40.0, count=10),
           _ev("fast_score_kernel<uchar, false>", us=20.0, count=10), _ev("other", us=99.0)]
    _traces(monkeypatch, [hit if traced else hit[2:]] * kt.PROFILE_ATTEMPTS)
    got = kt.profiler_kernel_us(lambda: None, "fast_score_kernel")
    assert got == (3.0 if traced else None)
