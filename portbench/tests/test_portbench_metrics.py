"""The traced stretch's reduction and the per-layer readers, on a
synthetic trace."""

from types import SimpleNamespace

import pytest

from portbench import harness, metrics, trace, yardstick


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    ev("user_annotation", "portbench.stretch", 0.0, 1000.0),
    ev("user_annotation", "portbench.advance", 0.0, 300.0),
    ev("user_annotation", "portbench.advance", 300.0, 300.0),
    ev("user_annotation", "portbench.read", 600.0, 400.0),
    ev("kernel", "void separable_fwd_point_kernel<float, 16>", 100.0, 100.0),
    ev("kernel", "void separable_bwd_point_kernel<float, 16>", 150.0, 150.0),
    ev("kernel", "void at::native::add_kernel", 400.0, 100.0),
    ev("gpu_memcpy", "Memcpy DtoH", 700.0, 50.0),
    ev("kernel", "outside", 2000.0, 10.0),
    ev("cuda_runtime", "cudaGraphLaunch", 10.0, 5.0),
]


def test_parse():
    p = trace.parse(EVENTS)
    assert p["window_s"] == pytest.approx(1e-3)
    # busy: [100, 300] + [400, 500] + [700, 750]
    assert p["busy_s"] == pytest.approx(350e-6)
    assert p["group_s"]["K1"] == pytest.approx(250e-6)
    assert p["group_s"]["torch"] == pytest.approx(150e-6)
    # gaps [0, 100], [300, 400], [500, 700], [750, 1000], longest first,
    # each named by the span the host was in when it began
    assert [g[0] for g in p["gaps"]] == ["read", "advance", "advance",
                                         "advance"]
    assert p["gaps"][0][1] == pytest.approx(250e-6)


def ctx(**kw):
    base = dict(model={"arch": "separable", "hidden": 16, "hidden_e": 32,
                       "hidden_alpha": 8}, dtype="float32", points=1 << 20,
                kernel_points=1 << 20, steps=1000, window_s=2.5,
                spans=[1e-5, 3e-5], launches=2000,
                step_flops=23_821.0 * (1 << 20),
                profile={"steps": 100, "window_s": 0.25, "busy_s": 0.2,
                         "group_s": {"K1": 0.061, "torch": 0.18}})
    base.update(kw)
    return SimpleNamespace(**base)


def test_readers():
    c = ctx()
    read = {n: metrics.load(n).read(c) for n in (
        "host_us_per_step", "kernel_launches_per_step",
        "torch_ops_ms_per_step", "k1_roofline", "k2_roofline", "mfu",
        "device_idle_share")}
    assert read["host_us_per_step"] == pytest.approx(20.0)
    assert read["kernel_launches_per_step"] == 2.0
    assert read["torch_ops_ms_per_step"] == pytest.approx(1.8)
    bound = sum(yardstick.bound_ms(1 << 20, 16, "float32", w, "K1")[0]
                for w in ("fwd", "bwd"))
    assert read["k1_roofline"] == pytest.approx(100 * bound / 0.61)
    assert read["k2_roofline"] is None       # no K2 in the stretch
    assert read["mfu"] == pytest.approx(
        100 * 23_821 * (1 << 20) * 1000 / 2.5 / 67e12)
    assert read["device_idle_share"] == pytest.approx(20.0)


def test_readers_that_find_nothing_return_nothing():
    c = ctx(spans=[], steps=0, profile={"steps": 0, "window_s": 0.0,
                                        "busy_s": 0.0, "group_s": {}})
    for name in ("host_us_per_step", "kernel_launches_per_step",
                 "torch_ops_ms_per_step", "k1_roofline", "mfu",
                 "device_idle_share"):
        assert metrics.load(name).read(c) is None, name


def test_every_profiled_metric_is_a_reader():
    for name in harness.PROFILED:
        assert callable(metrics.load(name).read)
