"""The port's bench line (``bench``, ``cli bench``, ``ops.ceiling``) and its
two A/B benchmarks (``benchmarks.pallas_ab``, ``benchmarks.pallas_train_ab``)
against the root ``bench.py`` and the JAX package's scripts, on the CPU
at small sizes (the plain versions of the kernels; the card's numbers come
from chip_smoke.py phase 22).

- the symmetric FLOP count equals ``bench.analytic_flops_per_point``
  exactly; the line has the root bench's key set, nested keys included
  (its ``main`` run with its measurements stubbed);
- ``cli bench --device cpu`` prints one line of finite values;
- the ceiling chains' plain version against a numpy chain (float32, to
  1e-6 relative), and their operation counts;
- the baseline step leaves the process's default dtype and seed alone, and
  caches only on an idle host;
- the A/B scripts report the JAX scripts' structure, under the port's
  paths' names, with finite numbers and their differences in bound.
"""

import json
import math
import sys

import numpy as np
import pytest
import torch

import bench as jbench
import pinn_for_quantum_wavefunction_surfaces_tpu as pqs
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import bench, cli
from pinn_for_quantum_wavefunction_surfaces_tpu_torch import config as tcfg
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.benchmarks import (
    pallas_ab, pallas_train_ab)
from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops import ceiling

from test_torch_excited import one_torch_thread  # noqa: F401

CPU_BENCH = ["bench", "--device", "cpu", "--n", "256", "--steps", "2",
             "--repeats", "1", "--no-baseline"]


@pytest.mark.parametrize("widths", [{}, dict(hidden=8, hidden_e=16,
                                             hidden_gate=4),
                                    dict(hidden=32)])
def test_symmetric_flops_equal_the_jax_bench(widths):
    want = jbench.analytic_flops_per_point(
        pqs.Config(model=pqs.ModelConfig(**widths)))
    got = bench.analytic_flops_per_point(
        tcfg.Config(model=tcfg.ModelConfig(**widths)))
    assert got == want
    if not widths:
        assert got == 30852.0


def test_separable_flops_count():
    """K1's forward and backward counts (PERF.md section 6), the rest of
    the step three times its forward, and Adam."""
    cfg = tcfg.Config(model=tcfg.ModelConfig(arch="separable"))
    assert bench.separable_flops_per_point(cfg) == 23821.0
    h = 8
    cfg = tcfg.Config(model=tcfg.ModelConfig(arch="separable", hidden=h))
    want = (12 * h * h + 58 * h + 117) + (36 * h * h + 178 * h + 236) \
        + 3 * (32 * 6 + 2 * 32 * 32 + 2 * 32 + 2 * 8 * 8 + 30) + 18
    assert bench.separable_flops_per_point(cfg) == want


def _keys(d: dict) -> dict:
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def test_bench_line_has_the_jax_keys(monkeypatch, capsys):
    """The root bench.py's printed line (its measurements stubbed) and the
    port's line have the same keys, nested ones included."""
    ours = {"points_per_sec": 1.0, "points_per_sec_median": 1.0,
            "points_per_sec_worst": 1.0, "timed_chunks": 1,
            "flops_per_point": 1.0, "flops_source": "analytic",
            "kernel": "xla"}
    monkeypatch.setattr(jbench, "measure_ours", lambda *a, **k: dict(ours))
    monkeypatch.setattr(jbench, "measure_vpu_ceilings", lambda: {
        "fma_flops_per_sec": 1.0, "tanh_ops_per_sec": 1.0})
    monkeypatch.setattr(sys, "argv", ["bench.py", "--no-baseline"])
    jbench.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = bench.bench_line(dict(ours), {"fma_flops_per_sec": 1.0,
                                        "tanh_ops_per_sec": 1.0}, None,
                           dict(ours))
    assert _keys(got) == _keys(want)


def test_cli_bench_prints_one_finite_line(capsys):
    cli.main(CPU_BENCH)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["kernel"] == "plain"
    assert line["flops_source"] == "analytic"
    assert line["peak_source"] == "measured_fma_chain"
    assert line["flops_per_point"] == 30852.0
    assert line["separable"]["flops_per_point"] == 23821.0
    nums = [v for v in list(line.values()) + list(line["separable"].values())
            if isinstance(v, float)]
    assert nums and all(math.isfinite(v) for v in nums)
    assert line["value"] > 0 and line["separable"]["points_per_sec"] > 0
    assert 0 < line["peak_fraction"]


def test_bench_needs_cuda_unless_asked_for_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(CPU_BENCH[:1] + CPU_BENCH[3:])


@pytest.mark.parametrize("which", ["fma", "tanh"])
def test_ceiling_chain_plain_against_numpy(which):
    """The plain chains against the same chains in numpy float32, and the
    CPU dispatch takes the plain version."""
    x0 = torch.rand(64, generator=torch.Generator().manual_seed(0))
    a, b, iters = 0.9999, 1e-6, 3
    v = x0.numpy()[:, None] + np.float32(1e-3) * np.arange(
        ceiling.CHAINS, dtype=np.float32)
    for _ in range(iters * ceiling.UNROLL[which]):
        v = (v * np.float32(a) + np.float32(b) if which == "fma"
             else np.tanh(v * np.float32(a)))
    want = v.sum(axis=1) + (0 if which == "fma" else np.float32(b))
    got = ceiling.chain(x0, iters, a, b, which)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert torch.equal(got, ceiling.chain_plain(x0, iters, a, b, which))
    assert ceiling.operations(64, iters, which) == (
        (2 if which == "fma" else 1) * 64 * ceiling.CHAINS
        * ceiling.UNROLL[which] * iters)


def test_ceilings_on_the_cpu_are_finite():
    out = bench.measure_ceilings("cpu")
    assert out["fma_flops_per_sec"] > 0 and out["tanh_ops_per_sec"] > 0
    assert out["chains"] == ceiling.CHAINS


def test_torch_baseline_leaves_the_process_alone():
    dtype = torch.get_default_dtype()
    state = torch.random.get_rng_state()
    out = bench.measure_torch_baseline(n=256, steps=1)
    assert out["device"] == "cpu-torch-f64" and out["n"] == 256
    assert math.isfinite(out["points_per_sec"]) and out["points_per_sec"] > 0
    assert torch.get_default_dtype() == dtype
    assert torch.equal(torch.random.get_rng_state(), state)


def test_baseline_cache_rule(tmp_path, monkeypatch):
    """A cached baseline is read back; a fresh one is cached only on an
    idle host."""
    cache = tmp_path / "bench_baseline_torch.json"
    fake = {"points_per_sec": 2.0, "n": 1, "device": "cpu-torch-f64"}
    monkeypatch.setattr(bench, "measure_torch_baseline", lambda: dict(fake))
    monkeypatch.setattr(bench.os, "getloadavg", lambda: (3.0, 3.0, 3.0))
    assert bench.load_baseline(str(cache)) == fake
    assert not cache.exists()
    monkeypatch.setattr(bench.os, "getloadavg", lambda: (0.1, 0.1, 0.1))
    assert bench.load_baseline(str(cache)) == fake
    assert json.loads(cache.read_text()) == fake
    monkeypatch.setattr(bench, "measure_torch_baseline", None)
    assert bench.load_baseline(str(cache)) == fake


def test_pallas_ab_reports_the_jax_structure(capsys):
    """The JAX script's report keys under the port's two paths' names,
    and a difference within the script's bound."""
    rep = pallas_ab.main(n=2048, reps=1, iters=2, check_n=512, device="cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == rep
    assert sorted(rep) == sorted(["n", "iters_per_call", "fwdlap", "k3",
                                  "max_abs_diff", "speedup_k3_vs_fwdlap"])
    for path in ("fwdlap", "k3"):
        assert sorted(rep[path]) == ["ms", "points_per_sec"]
        assert rep[path]["points_per_sec"] > 0
    assert 0 <= rep["max_abs_diff"] <= pallas_ab.DIFF_BOUND


@pytest.mark.parametrize("model", ["flagship", "parity"])
def test_pallas_train_ab_reports_the_jax_structure(model, capsys):
    out = pallas_train_ab.main(n=512, steps=3, model=model, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines[:2]] == ["fwdlap", "k2"]
    assert json.loads(lines[-1]) == out
    assert sorted(out) == sorted(["model", "n", "k2_points_per_sec",
                                  "fwdlap_points_per_sec", "k2_over_fwdlap",
                                  "loss_rel_dev"])
    assert out["model"] == model and out["n"] == 512
    assert 0 <= out["loss_rel_dev"] <= pallas_train_ab.LOSS_REL_BOUND


def test_fwdlap_loss_equals_the_route_on_the_cpu():
    """The A/B's fwdlap loss and the kernel route's loss_fn (its plain
    version on the CPU) on one batch: the same terms, float64."""
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.models import \
        ansatz
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.ops.sampling \
        import sample_batch
    from pinn_for_quantum_wavefunction_surfaces_tpu_torch.training import \
        losses
    cfg = tcfg.Config(model=pallas_train_ab.MODELS["flagship"],
                      dtype="float64")
    params = ansatz.init_params(cfg.model, seed=3, dtype=torch.float64,
                                device="cpu")
    batch = sample_batch(torch.Generator().manual_seed(0), cfg, n=256)
    l1, a1 = losses.loss_fn(params, cfg, batch)
    l2, a2 = pallas_train_ab.fwdlap_loss(params, cfg, batch)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-12)
    np.testing.assert_allclose(float(a2.l_bc), float(a1.l_bc), rtol=1e-12)
