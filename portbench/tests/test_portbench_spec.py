"""The harness finds every part of a cell by name, and a cell, a traffic
mix and a per-layer metric added as files are picked up with no edit."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness, mixes, yardstick

ROOT = Path(harness.__file__).resolve().parents[1]


def test_benchmark_names_every_file():
    bench = harness.benchmark()
    assert bench["paths"] == ["portbench"]
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in bench["workloads"]:
        cell = harness.resolve(w["name"], bench)
        assert cell.config["name"] == w["config"]
        assert cell.kind is mixes.load(cell.traffic["kind"])
        assert cell.limits, f"{w['name']} has no limits"
        assert {m["name"] for m in cell.end_to_end} == {"points_per_s",
                                                        "setup_s"}
        assert len(cell.per_layer) >= 1


@pytest.mark.parametrize("name,expected", [
    ("flagship-separable.polish-adam",
     {"k1_roofline", "host_us_per_step", "kernel_launches_per_step",
      "torch_ops_ms_per_step", "mfu", "device_idle_share"}),
    ("flagship-separable.mc",
     {"k1_roofline", "host_us_per_step", "kernel_launches_per_step",
      "torch_ops_ms_per_step", "mfu", "device_idle_share"}),
    ("paper-symmetric-gz.train",
     {"k2_roofline", "host_us_per_step", "kernel_launches_per_step",
      "torch_ops_ms_per_step", "mfu", "device_idle_share"})])
def test_each_cell_reports_its_metrics(name, expected):
    cell = harness.resolve(name, harness.benchmark())
    assert set(cell.per_layer) == expected
    for metric in cell.per_layer.values():
        assert callable(metric.read)


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.resolve("no-such.cell", harness.benchmark())


def test_the_yardstick_knows_both_families():
    for name in ("flagship-separable", "paper-symmetric-gz"):
        cfg = json.loads((ROOT / f"portbench/configs/{name}.json")
                         .read_text())
        assert yardstick.flops_per_point(cfg["model"]) > 0


NEW_METRIC = '''"""Steps of the window: a metric added as a file."""


def read(ctx):
    return float(ctx.steps)
'''

PROBE = '''
import json, torch
torch.set_num_threads(1)
from portbench import harness
cell = harness.resolve("flagship-separable.tiny", harness.benchmark())
res, _ = harness.run(cell, 7, 0.2, True, "cpu", log=lambda *a, **k: None)
print(json.dumps({"metrics": res["metrics"], "correct": res["correct"],
                  "harness": harness.__file__}))
'''


def test_a_cell_mix_and_metric_added_as_files(tmp_path):
    """A throw-away traffic mix, workload, limits file and per-layer metric,
    added to a copy of the benchmark, run there with no edit of any file
    the copy already had."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads((ROOT / "portbench/traffic/polish-adam.json")
                         .read_text())
    traffic.update(n_r=2, n_xi=8, n_eta=6, read_every=2)
    (tmp_path / "portbench/traffic/tiny.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench/limits/flagship-separable.tiny.json").write_text(
        json.dumps({"limits": {"loss": {"limit": 1e-12}}}))
    (tmp_path / "portbench/metrics/steps_seen.py").write_text(NEW_METRIC)
    bench["workloads"].append({"name": "flagship-separable.tiny",
                               "config": "flagship-separable",
                               "traffic": "tiny", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "trainer loop",
                               "moves": "points_per_s",
                               "workloads": ["flagship-separable.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path),
                                                       str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["harness"].startswith(str(tmp_path))
    assert res["correct"] is True
    assert res["metrics"]["steps_seen"]["value"] > 0
    assert res["metrics"]["steps_seen"]["unit"] == "steps"
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_without_the_program_a_run_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder: the
    run stops before any result, for want of the program."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    probe = ("from portbench import harness\n"
             "cell = harness.resolve('flagship-separable.polish-adam',"
             " harness.benchmark())\n"
             "harness.run(cell, 1, 0.1, False, 'cpu')\n"
             "print('{\"correct\": true}')\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "pinn_for_quantum_wavefunction_surfaces_tpu_torch" in out.stderr
    out = subprocess.run([sys.executable, "-m", "portbench.run",
                          "--workload", "flagship-separable.polish-adam",
                          "--seed", "1", "--seconds", "1"], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
