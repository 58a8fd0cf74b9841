"""PR++ (Dual-PRNet++) in the benchmark, on the CPU: the port's plain path
against the benchmark's plain reference (`bench_port/reference/
prplusplus.py`) at 32^3 in float64, the plain correlation against the
reference's own, K7's routing rule, the configuration's parameter names,
the K7 yardstick and readers, and the two training cells `rdn.train` and
`prplusplus.train` run whole at small sizes. Imports no JAX."""

import json
import shutil

import pytest
import torch

from bench_port import calibrate, harness, work
from bench_port.reference.common import Ops
from bench_port.reference.train import AMSGrad, loss_terms
from bench_port.work import correlation

CONFIG = "prplusplus-lpba40"
SIZE = (32, 32, 32)  # at 16^3 the coarsest level is one voxel
TOL = 1e-5  # relative to each quantity's largest magnitude (float64 both sides)
# the program's float32 trilinear fractions move the gradients by ~1e-5
GRAD_TOL = 1e-4


def _config():
    return harness._json(f"{harness.ROOT}/configs/{CONFIG}.json")


def _model(params=None, attn_impl="plain"):
    from smilecode_tpu_torch.config import TrainConfig
    from smilecode_tpu_torch.models.registry import build_model

    config = _config()
    cfg = TrainConfig()
    for k, v in config["knobs"].items():
        setattr(cfg, k, v)
    cfg.model, cfg.attn_impl = config["model"], attn_impl
    model = build_model(config["model"], cfg, device="cpu")
    if params is not None:
        model = model.double()
        model.load_state_dict(params, strict=True)
    return model


def _setup():
    from smilecode_tpu_torch.models.registry import loss_plan

    config = _config()
    ref = harness.reference_module(config)
    params = harness.make_params(ref.param_shapes(config["knobs"]), config["init"],
                                 torch.Generator().manual_seed(11), "cpu")
    params = {k: v.double() for k, v in params.items()}
    g = torch.Generator().manual_seed(12)
    fields = torch.rand((2, 1, 1, 4, 4, 4), generator=g, dtype=torch.float64)
    x, y = (torch.nn.functional.interpolate(f, size=SIZE, mode="trilinear", align_corners=True)
            for f in fields)
    return ref, config["knobs"], params, _model(params), loss_plan(config["model"]), x, y


def _gap(a, b):
    return float((a - b).detach().abs().max() / b.detach().abs().max().clamp_min(1e-30))


def test_forward_loss_gradients_and_update_match_the_reference():
    """The port's PR++ on its plain path and the reference on one seeded
    state dict drawn by the configuration's ``init``: the flow, the moved
    image, the loss, every leaf's gradient and one AMSGrad update."""
    from smilecode_tpu_torch.models.registry import CRITERIA
    from smilecode_tpu_torch.optim import AMSGrad as PortAMSGrad

    ref, knobs, params, model, plan, x, y = _setup()
    ndhwc = (x.permute(0, 2, 3, 4, 1), y.permute(0, 2, 3, 4, 1))
    outs = model(*ndhwc)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    routs = ref.forward(p, Ops(), knobs, x, y)
    assert float(routs[1].abs().max()) > 0.5  # flow heads N(0, 0.2): flows that move voxels
    assert _gap(outs[1].permute(0, 4, 1, 2, 3), routs[1]) < TOL
    assert _gap(outs[0].permute(0, 4, 1, 2, 3), routs[0]) < TOL

    sel = plan.select_train_outputs(outs)
    loss = sum(CRITERIA[c](o, ndhwc[1]) * w for c, o, w in zip(plan.criterions, sel, [1.0, 1.0]))
    rloss = sum(loss_terms(ref.train_outputs(routs), y, knobs["weights"]))
    assert abs(float(loss) - float(rloss)) < TOL * abs(float(rloss))

    loss.backward()
    grads = torch.autograd.grad(rloss, list(p.values()), allow_unused=True)
    grads = {k: (torch.zeros_like(p[k]) if g is None else g) for k, g in zip(p, grads)}
    named = dict(model.named_parameters())
    for k, g in grads.items():
        assert float((named[k].grad - g).abs().max()) <= GRAD_TOL * float(g.abs().max()) + 1e-12, k

    PortAMSGrad(model.parameters(), lr=knobs["lr"]).step()
    AMSGrad(p).step(p, grads, knobs["lr"])
    for k in p:
        # an element whose gradient is within the gradients' gap of 0 may move
        # either way: compare those above 1e-3 of the leaf's largest
        g = grads[k].abs()
        sure = g > 1e-3 * float(g.max())
        gap = (named[k].detach() - p[k].detach()).abs()[sure]
        assert gap.numel() == 0 or float(gap.max()) < 1e-3 * knobs["lr"], k


def test_param_shapes_are_the_ports_state_dict():
    ref = harness.reference_module(_config())
    shapes = ref.param_shapes(_config()["knobs"])
    state = {k: tuple(v.shape) for k, v in _model().state_dict().items()}
    assert list(shapes) == list(state)
    assert {k: tuple(v) for k, v in shapes.items()} == state


@pytest.mark.parametrize("shape,c", [((2, 5, 7, 9), 8), ((1, 7, 6, 5), 16), ((1, 3, 5, 4), 32)])
def test_plain_correlation_is_the_references_and_its_gradient_checks(shape, c):
    """`correlation3d_plain` (NDHWC, shifted-slice box sums) against the
    reference's own (NCDHW, SmileCode's grouped ones-kernel convolution and
    shifted crops) at odd, unequal shapes; then `gradcheck` of the plain
    version's backward in float64 at a smaller size."""
    from smilecode_tpu_torch.kernels.correlation3d import correlation3d_plain

    ref = harness.reference_module(_config())
    g = torch.Generator().manual_seed(c)
    mov, fix = (torch.randn((*shape, c), generator=g, dtype=torch.float64) for _ in range(2))
    got = correlation3d_plain(mov, fix)
    want = ref.correlation(mov.permute(0, 4, 1, 2, 3), fix.permute(0, 4, 1, 2, 3))
    assert got.shape == (*shape, 27)
    torch.testing.assert_close(got, want.permute(0, 2, 3, 4, 1), rtol=1e-12, atol=1e-12)
    small = tuple(min(n, 4) for n in shape[1:])
    m, f = (torch.randn((1, *small, 3), generator=g, dtype=torch.float64, requires_grad=True)
            for _ in range(2))
    assert torch.autograd.gradcheck(correlation3d_plain, (m, f))


@pytest.mark.parametrize("dtype,device,channels,kernels,to_k7", [
    (torch.float32, "cuda", 8, True, True),
    (torch.float32, "cuda", 16, True, True),
    (torch.float32, "cuda", 32, True, True),
    (torch.float32, "cuda", 3, True, True),
    (torch.float32, "cuda", 33, True, True),
    (torch.float32, "cuda", 64, True, True),
    (torch.float32, "cuda", 128, True, True),
    (torch.float32, "cuda", 129, True, ValueError),
    (torch.float32, "cuda", 0, True, ValueError),
    (torch.float64, "cuda", 16, True, ValueError),
    (torch.bfloat16, "cuda", 16, True, ValueError),
    (torch.float16, "cuda", 16, True, ValueError),
    (torch.float32, "cpu", 16, True, False),
    (torch.float64, "cpu", 16, True, False),
    (torch.float32, "cpu", 200, True, False),
    (torch.float32, "cuda", 16, False, False),
    (torch.float64, "cuda", 200, False, False),
])
def test_k7_route(dtype, device, channels, kernels, to_k7):
    """On the card, in a model whose kernel switch is on (attn_impl
    "auto"), every correlation goes to K7, and one K7 cannot take (not
    float32, or wider than its MAX_CHANNELS) raises; the CPU and a plain
    model take the plain version whatever the dtype and width."""
    from smilecode_tpu_torch.kernels.correlation3d import k7_route

    if to_k7 is ValueError:
        with pytest.raises(ValueError, match="K7 takes float32"):
            k7_route(dtype, device, channels, kernels)
    else:
        assert k7_route(dtype, device, channels, kernels) is to_k7


def test_cpu_correlation_takes_the_plain_version_and_launches_nothing():
    from smilecode_tpu_torch.kernels import launch_counters
    from smilecode_tpu_torch.kernels.correlation3d import correlation3d, correlation3d_plain

    g = torch.Generator().manual_seed(3)
    mov, fix = (torch.randn((1, 4, 5, 6, 8), generator=g) for _ in range(2))
    before = launch_counters()
    assert torch.equal(correlation3d(mov, fix), correlation3d_plain(mov, fix))
    assert launch_counters() == before and "K7 launches" in before
    model = _model(attn_impl="auto")
    assert all(getattr(model, f"prblock{i}").kernels for i in range(1, 6))
    assert not any(getattr(_model(), f"prblock{i}").kernels for i in range(1, 6))


def test_k7_work_counts_ten_calls_a_step():
    """Five forwards and five adjoints a step at PR++'s level shapes and
    widths, five forwards a pair; each input read once and each output
    written once: 5.41 GB a step, 1.614 ms at 3.35 TB/s."""
    calls = correlation.calls(_config(), True)
    assert [k for k, _, _ in calls] == ["fwd", "bwd"] * 5
    assert [(v, c) for k, v, c in calls if k == "fwd"] == [
        (9600, 32), (76800, 32), (614400, 16), (4915200, 16), (4915200, 8)]
    assert [k for k, _, _ in correlation.calls(_config(), False)] == ["fwd"] * 5
    assert correlation.work("fwd", 10, 8) == (4 * 10 * (2 * 8 + 27), 10 * (66 * 8 + 27))
    assert correlation.work("bwd", 10, 8) == (4 * 10 * (27 + 4 * 8), 10 * 122 * 8)
    bound_ms = sum(work.bound(*correlation.work(*call))[0] for call in calls)
    assert bound_ms == pytest.approx(1.6144, rel=1e-4)  # bytes bound: 5.41 GB at 3.35 TB/s


def test_k7_names_are_in_the_source():
    import os

    with open(os.path.join(os.path.dirname(harness.ROOT), "smilecode_tpu_torch", "csrc",
                           "correlation3d.cu")) as f:
        src = f.read()
    for name in correlation.GLOBALS:
        assert f"{name[:-1]}(" in src, name


def test_k7_readers_on_hand_worked_traces():
    record = {"config": _config(), "kind": "train", "traced_units": 2, "device_events": [
        (0, 3000, "void (anonymous namespace)::correlation3d_fwd_kernel<4>(float const*, ...)"),
        (3000, 4000, "void (anonymous namespace)::correlation3d_box_kernel<4>(float const*, ...)"),
        (4000, 7000, "void (anonymous namespace)::correlation3d_bwd_mov_kernel<4>(...)"),
        (7000, 12914, "void (anonymous namespace)::correlation3d_bwd_fix_kernel<1>(...)"),
        (12914, 20000, "void cudnn::cnn::wgrad2d_grouped_direct_kernel<true, true, int>(...)")]}
    ms = harness.reader("k7_device_ms.train-prpp")(record)
    assert ms == pytest.approx(6.457)  # 12914 us over 2 steps
    share = harness.reader("k7_roofline.train-prpp")(record)
    assert share == pytest.approx(100 * 1.61438 / 6.457, rel=1e-4)
    record["kind"] = "register"  # the forwards alone
    fwd = sum(work.bound(*correlation.work(*c))[0] for c in correlation.calls(_config(), False))
    assert harness.reader("k7_roofline.train-prpp")(record) == pytest.approx(100 * fwd / 6.457)
    record["device_events"] = record["device_events"][-1:]
    for name in ("k7_device_ms.train-prpp", "k7_roofline.train-prpp"):
        assert harness.reader(name)(record) is None
        assert harness.reader(name)({**record, "device_events": []}) is None


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """(bench, root) of a copy whose configurations are small: PR++ at 32^3,
    RDN at 64^3 with stages 2 and one estimate a level."""
    tmp = tmp_path_factory.mktemp("small")
    shutil.copytree(harness.ROOT, tmp / "bench_port", ignore=shutil.ignore_patterns("__pycache__"))
    sizes = {CONFIG: ([32, 32, 32], {}),
             "rdn-lpba40": ([64, 64, 64], {"stages": 2, "levels": [1, 1, 1, 1]})}
    for name, (vol, knobs) in sizes.items():
        path = tmp / "bench_port" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg["volume"], cfg["n_subjects"] = vol, 3
        cfg["knobs"].update(knobs)
        path.write_text(json.dumps(cfg))
    bench = harness.load_benchmark()
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench, str(tmp / "bench_port")


@pytest.mark.parametrize("cell", ["prplusplus.train", "rdn.train"])
def test_the_new_cells_run_whole_and_the_control_fails_their_limits(small, cell):
    """A traced run of each new cell at a small size on the CPU: the result
    line, a check for every limit, the host-clock metrics; then the
    control (the reference on TF32-rounded operands) fails the cell's own
    limits, and AMSGrad's state left unchanged fails them too."""
    bench, root = small
    limits = harness.load_limits(cell)
    assert set(limits) >= {"flow_gap", "flow_mean_gap", "grad_gap", "change_median_gap"}
    out = harness.execute(cell, 2 ** 31 + 99, 1.0, True, "cpu", bench=bench, root=root)
    assert out["failed"] == 0 and out["attempted"] >= 2
    assert set(out["checks"]) == set(limits)
    suffix = "train-prpp" if cell == "prplusplus.train" else "train-rdn"
    assert {f"loader_wait_ms.{suffix}", f"step_mfu.{suffix}"} <= set(out["metrics"])
    got = calibrate.readings(cell, 5, 0.5, True, "cpu", bench, root)
    assert not harness.is_correct(harness.checks(got["control"], limits)), got
    with calibrate.fault("unchanged"):
        got = calibrate.readings(cell, 6, 0.5, False, "cpu", bench, root)
    assert not harness.is_correct(harness.checks(got["program"], limits)), got
