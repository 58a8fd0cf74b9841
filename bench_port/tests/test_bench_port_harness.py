"""The harness on the CPU: the contract of `BENCHMARK.json`, the window
arithmetic, cells added as files, and the check for JAX."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from bench_port import harness
from bench_port.window import idle_gaps, percentile, union_length

CHECKOUT = os.path.dirname(harness.ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def test_benchmark_keys_names_and_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "bench_port/run.py"] and bench["paths"] == ["bench_port"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(n), n
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(CHECKOUT, c["file"])) and c["file"].startswith("bench_port/")
        cfg = harness._json(os.path.join(CHECKOUT, c["file"]))
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in [m["name"] for m in bench["end_to_end"]]
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_each_cell_reports_what_its_layer_metrics_move(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell = w["name"]
        reported = {m["name"] for m in harness.cell_metrics(bench, cell, "end_to_end")}
        layer = harness.cell_metrics(bench, cell, "per_layer")
        assert "setup_s" in reported and len(reported) >= 2 and layer
        for m in layer:
            assert m["moves"] in e2e and m["moves"] in reported, (cell, m["name"])
        for m in bench["end_to_end"] + bench["per_layer"]:  # every metric has a reader
            harness.reader(m["name"])


def _record(**kw):
    rec = dict(kind="train", units=4, window_s=2.0, setup_s=12.5, config={"peak": {
        "ops_per_s": 67e12, "bytes_per_s": 3.35e12}})
    rec.update(kw)
    return rec


def test_rates_are_over_the_whole_window():
    assert harness.reader("train_step_ms")(_record()) == pytest.approx(500.0)
    rec = _record(kind="register", units=10, window_s=4.0,
                  latencies_s=[0.1] * 90 + [0.2] * 9 + [5.0])
    assert harness.reader("register_pairs_per_s")(rec) == pytest.approx(2.5)
    # the tail is the 95th percentile of every pair's latency, the stall included
    assert harness.reader("register_ms_p95")(rec) == pytest.approx(
        1e3 * percentile(rec["latencies_s"], 95))
    assert percentile([1, 2, 3, 4, 5], 50) == 3 and percentile(list(range(101)), 95) == 95


def test_a_traced_run_keeps_an_untraced_half_for_the_host_clock():
    """With the profiler the host-clock numbers come from the window's
    first half, outside it; the device's from the traced second half."""
    calls = []
    run = type("R", (), {"device": harness.torch.device("cpu")})()
    out = harness._window(run, 0.2, False, lambda traced: calls.append(traced))
    assert out["prof"] is None and out["traced_units"] == 0 and not any(calls)
    assert out["units"] == len(calls) and out["window_s"] >= 0.2
    calls.clear()
    out = harness._window(run, 0.2, True, lambda traced: calls.append(traced))
    assert out["prof"] is not None and 0.1 <= out["window_s"] < 0.2
    assert calls == [False] * out["units"] + [True] * out["traced_units"]
    rec = _record(units=4, window_s=2.0, work={"flops": 67e12 * 0.5 * 0.01})
    assert harness.reader("step_mfu.train")(rec) == pytest.approx(1.0)


@pytest.mark.parametrize("change", [{"dtype": "bfloat16"}, {"tf32": True}])
def test_a_precision_the_reference_lacks_is_refused(change):
    cfg = harness._json(os.path.join(harness.ROOT, "configs", "modet-lpba40.json"))
    harness.precision(cfg)
    cfg.update(change)
    with pytest.raises(ValueError, match="float32 with TF32 off"):
        harness.precision(cfg)


def test_idle_union_shows_an_injected_stall():
    busy = [(0.0, 2.0), (1.0, 4.0), (6.0, 10.0)]  # stalled from 4 to 6
    assert union_length(busy, 0.0, 10.0) == pytest.approx(8.0)
    assert idle_gaps(busy, 0.0, 10.0) == [(4.0, 6.0)]
    rec = _record(busy_s=union_length(busy, 0.0, 10.0) / 1e6, traced_s=10.0 / 1e6)
    assert harness.reader("idle_share.train")(rec) == pytest.approx(20.0)


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(["smilecode_tpu_torch", "smilecode_tpu_torch.train",
                                      "torch", "jaxtyping"]) == []
    assert harness.forbidden_modules(["smilecode_tpu.models", "jax.numpy", "flax"]) == [
        "flax", "jax", "smilecode_tpu"]
    import smilecode_tpu_torch.train  # noqa: F401

    assert harness.forbidden_modules(sys.modules) == []


def test_run_refuses_without_a_card():
    proc = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "modet.train",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=CHECKOUT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                with open(os.path.join(d, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, f), root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_config_mix_and_metric_added_as_files(tmp_path):
    """A new configuration, traffic mix and per-layer metric are new files
    and new entries of BENCHMARK.json; no file of the harness changes."""
    shutil.copytree(harness.ROOT, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    root = str(tmp_path / "bench_port")
    before = _digest(root)
    cfg = harness._json(os.path.join(root, "configs", "modet-lpba40.json"))
    cfg.update(name="dummy-modet", volume=[32, 32, 32], n_subjects=3)
    (tmp_path / "bench_port" / "configs" / "dummy-modet.json").write_text(json.dumps(cfg))
    (tmp_path / "bench_port" / "traffic" / "dummy-mix.json").write_text(json.dumps(
        {"kind": "register", "dataset": "s2s", "num_workers": 1}))
    (tmp_path / "bench_port" / "metrics" / "dummy_pairs.py").write_text(
        "def read(record):\n    return float(record['units'] + record['traced_units'])\n")
    bench = harness.load_benchmark()
    bench["configs"].append({"name": "dummy-modet", "source": "x", "reduced": [], "why": "x",
                             "file": "bench_port/configs/dummy-modet.json"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy-modet", "traffic": "dummy-mix",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "dummy_pairs", "unit": "pairs", "better": "higher",
                               "source": "program_counter", "layer": "Data",
                               "moves": "register_pairs_per_s", "workloads": ["dummy.cell"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("register_pairs_per_s", "register_ms_p95"):
            m["workloads"].append("dummy.cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = harness.execute("dummy.cell", 2 ** 31 + 5, 0.5, True, "cpu", bench=bench, root=root)
    assert out["metrics"]["dummy_pairs"]["value"] == out["attempted"] >= 1
    out = harness.execute("dummy.cell", 3, 0.5, False, "cpu", bench=bench, root=root)
    assert set(out["metrics"]) == {"setup_s", "register_pairs_per_s", "register_ms_p95"}
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"configs/dummy-modet.json", "traffic/dummy-mix.json",
                                        "metrics/dummy_pairs.py"}
