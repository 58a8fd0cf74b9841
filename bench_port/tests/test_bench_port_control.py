"""`correct` comes out false where it should: for the control (the
reference in TF32 in the program's place) and for each fault a cell can
have, planted in the program underneath a whole run. On the CPU at small
sizes (ModeT 64^3, the half cell 32^3; RDN 64^3 with stages 2 and
one estimate a level), the look for a card skipped; the limits are the
cells' own (`limits/<cell>.json`)."""

import json
import shutil

import pytest
import torch

from bench_port import calibrate, harness

CELLS = ("modet.train", "rdn.register", "modet.register", "modet.train-half")


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """(bench, root) of a copy whose configurations are small."""
    tmp = tmp_path_factory.mktemp("small")
    shutil.copytree(harness.ROOT, tmp / "bench_port", ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_benchmark()
    sizes = {"modet-lpba40": ([64, 64, 64], {}),
             "rdn-lpba40": ([64, 64, 64], {"stages": 2, "levels": [1, 1, 1, 1]})}
    for name, (vol, knobs) in sizes.items():
        path = tmp / "bench_port" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg["volume"], cfg["n_subjects"] = vol, 3
        cfg["knobs"].update(knobs)
        path.write_text(json.dumps(cfg))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench, str(tmp / "bench_port")


@pytest.fixture(autouse=True)
def few_samples(monkeypatch):
    monkeypatch.setattr(harness, "SAMPLE_FROM", 3)
    monkeypatch.setattr(harness, "N_SAMPLED_PAIRS", 2)
    torch.manual_seed(0)


def _run(small, cell, seed=2 ** 31 + 99, seconds=1.0):
    bench, root = small
    return harness.execute(cell, seed, seconds, False, "cpu", bench=bench, root=root)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limits(small, cell):
    bench, root = small
    got = calibrate.readings(cell, 5, 1.0, True, "cpu", bench, root)
    limits = harness.load_limits(cell)
    assert not harness.is_correct(harness.checks(got["control"], limits)), got


@pytest.mark.parametrize("cell,name,number,least", [
    ("modet.train", "unchanged", "change_median_gap", 0.99),
    ("modet.train-half", "unchanged", "grad_gap", 0.99),
    ("modet.train", "loss", "loss1_gap", 0.009),
    ("modet.train-half", "loss", "loss1_gap", 0.009),
    ("rdn.register", "flow", "flow_gap", 0.99),
    ("modet.register", "flow", "flow_gap", 0.99),
    ("modet.register", "dice", "dice_gap", 0.009),
    ("modet.train", "flow", "flow_gap", 0.99),
])
def test_a_planted_fault_fails(small, cell, name, number, least):
    with calibrate.fault(name):
        out = _run(small, cell)
    assert out["correct"] is False and out["checks"][number]["value"] >= least
