"""chip_smoke.py's `kineto_figures`, which reads the profiler's raw
Kineto events, against the profiler's own event tree (`prof.events()`,
`key_averages()`) on the CPU: the host self time of every op and the
host time of every `convert.*` range equal to 1e-6 ms, on nested ranges
beside a second thread.  The device side (kernels and their stages) is held
on the card by tests/test_torch_gpu.py."""

import threading

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

import chip_smoke


def _work():
    x = torch.randn(64, 64, requires_grad=True)
    with record_function("convert.outer"):
        y = (x @ x).relu()
        with record_function("convert.inner"):
            z = torch.nn.functional.conv1d(y[None], torch.randn(8, 64, 3))
        loss = z.sum() + y.softmax(-1).sum()
    loss.backward()

    def side():
        with record_function("convert.thread"):
            torch.randn(32, 32).exp().sum()

    th = threading.Thread(target=side)
    th.start()
    th.join()


@pytest.mark.parametrize("calls", [1, 3])
def test_kineto_figures_match_the_profiler_tree(calls):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            _work()
    fig = chip_smoke.kineto_figures(prof.profiler.kineto_results.events(), "convert.")
    ref_self = {e.key: e.self_cpu_time_total / 1e3 for e in prof.key_averages()
                if e.device_type == DeviceType.CPU}
    assert set(fig["host_self"]) == set(ref_self)
    for k, v in ref_self.items():
        assert abs(fig["host_self"][k] - v) <= 1e-6, k
    ref_ranges = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("convert."):
            ref_ranges[e.name] = ref_ranges.get(e.name, 0.0) + e.cpu_time_total / 1e3
    assert set(fig["stages_host"]) == set(ref_ranges) >= {"convert.outer", "convert.inner"}
    for k, v in ref_ranges.items():
        assert abs(fig["stages_host"][k] - v) <= 1e-6, k
    assert fig["by_kernel"] == {} and fig["stages"] == {}
