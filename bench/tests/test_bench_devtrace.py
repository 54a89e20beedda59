"""The trace's reduction: busy time as the union of the device's
operations, range annotations left out, idle time labelled by the host."""
import pytest
import torch

from bench import devtrace

CPU, CUDA = False, True


def ev(name, a, b, dev=CPU, note=False):
    return devtrace.Event(name, a, b, dev, note)


def test_union_and_labels():
    events = [
        ev(devtrace.WINDOW, 0, 1000),
        ev("engine.step", 0, 600), ev("engine.step", 0, 600, CUDA, note=True),
        ev("bench.bookkeeping", 600, 1000),
        ev("cudaGraphLaunch", 10, 30), ev("aten::item", 650, 990),
        ev("kernel_a", 50, 300, CUDA), ev("kernel_b", 250, 400, CUDA),   # overlap: busy 350
        ev("kernel_a", 500, 505, CUDA),                                   # gap 100 before it
        ev("kernel_c", 700, 800, CUDA),
    ]
    t = devtrace.reduce(events)
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx((350 + 5 + 100) * 1e-6)
    assert t.kernels == pytest.approx({"kernel_a": 255e-6, "kernel_b": 150e-6, "kernel_c": 100e-6})
    assert t.device_ops == 4
    # idle: 0-50 over the launch, 400-500 and 505-700 inside the step / bookkeeping,
    # 800-1000 under the item read
    assert sum(t.idle.values()) == pytest.approx(1e-3 - t.busy_s)
    assert t.idle["engine.step > cudaGraphLaunch"] == pytest.approx(50e-6)
    assert t.idle["bench.bookkeeping > aten::item"] == pytest.approx(200e-6)
    assert devtrace.seconds_of(t.kernels, "kernel_a", "kernel_c") == pytest.approx(355e-6)
    assert devtrace.top(t.kernels, 1) == [["kernel_a", pytest.approx(255e-6)]]


def test_no_device_time_reads_nothing():
    assert devtrace.reduce([ev(devtrace.WINDOW, 0, 10), ev("aten::mm", 1, 2)]) is None
    assert devtrace.reduce([ev("kernel", 1, 2, CUDA)]) is None


def test_events_of_a_profile():
    """The raw events carry the window and the ranges inside it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(devtrace.WINDOW):
            with record_function("engine.step"):
                torch.ones(8).sum()
    events = devtrace.events_of(prof)
    window = next(e for e in events if e.name == devtrace.WINDOW)
    step = next(e for e in events if e.name == "engine.step")
    assert window.start <= step.start <= step.end <= window.end and not step.on_device
    assert any(e.name.startswith("aten::") for e in events)
    assert devtrace.reduce(events) is None              # no device: nothing to read
