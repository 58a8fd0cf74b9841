"""The benchmark of `smilecode_tpu_torch`, driven by data.

`BENCHMARK.json` names each cell's configuration and traffic mix; the files
that belong to them are found by name:

* ``configs/<config>.json``: the model, its knobs, the volume, the weights'
  initialisation rules, the reference module and the peak rates;
* ``traffic/<mix>.json``: the loop (``kind`` ``train`` or ``register``),
  the dataset variant and the loader's workers;
* ``metrics/<metric>.py`` (or ``metrics/<stem>.py`` for ``<stem>.<suffix>``):
  a ``read(record)`` that returns the metric, or None where the run gives it
  nothing to read;
* ``reference/<module>.py``: the plain reference;
* ``limits/<workload>.json``: the limit of each number that decides
  ``correct``.

One run: set-up (the kernels' library, weights and subjects from the seed,
the first steps or a warm-up pair through the program's own entries), a
measured window of ``seconds`` on the host clock (traced by
`torch.profiler` with ``trace``), then, with the program freed, the plain
reference over the same inputs and the comparison.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

from bench_port import data as bdata
from bench_port.reference.common import Ops
from bench_port.reference.train import AMSGrad as RefAMSGrad
from bench_port.reference.train import dice as ref_dice
from bench_port.reference.train import fold_fraction as ref_fold
from bench_port.reference.train import loss_terms, poly_lr as ref_poly_lr

ROOT = os.path.dirname(os.path.abspath(__file__))
N_CHECKED_STEPS = 3  # training steps of set-up that the reference follows
N_SAMPLED_PAIRS = 6  # registered pairs of the window that the reference checks
SAMPLE_FROM = 16  # drawn from the window's first requests
FORBIDDEN = ("jax", "jaxlib", "flax", "smilecode_tpu")


# -- files -------------------------------------------------------------------
def _json(path):
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(os.path.dirname(root), "BENCHMARK.json"))


def load_cell(bench: dict, workload: str, root: str = ROOT):
    """(cell, config, traffic) of ``workload``."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = _json(os.path.join(os.path.dirname(root), entry["file"]))
    traffic = _json(os.path.join(root, "traffic", f"{cell['traffic']}.json"))
    return cell, config, traffic


def cell_metrics(bench: dict, workload: str, section: str) -> list:
    """The metrics of ``section`` that cell ``workload`` reports: those that
    list it, and those without a list (every cell)."""
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: str = ROOT):
    """``read`` of ``metrics/<name>.py``, else of ``metrics/<stem>.py``."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(root, "metrics", f"{stem}.py")
        if os.path.exists(path):
            return _module(path, f"bench_port_metric_{stem}").read
    raise FileNotFoundError(f"no reader for metric {name!r} under {root}/metrics")


def reference_module(config: dict, root: str = ROOT):
    """``reference/<config's reference>.py``."""
    name = config["reference"]
    return _module(os.path.join(root, "reference", f"{name}.py"), f"bench_port_reference_{name}")


def load_limits(workload: str, root: str = ROOT) -> dict:
    path = os.path.join(root, "limits", f"{workload}.json")
    return _json(path) if os.path.exists(path) else {}


def forbidden_modules(modules) -> list:
    """Top-level names of ``modules`` that are JAX or the JAX package,
    compared whole (the port's name only begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


# -- weights and data from the seed ---------------------------------------------------
def make_params(shapes: dict, rules: list, generator: torch.Generator, device) -> dict:
    """One float32 tensor per name of ``shapes``, drawn on ``device`` from
    ``generator`` in two calls (uniform, normal). ``rules``: [suffix, kind,
    scale] tried in order, kind ``fan_in`` (U(-s, s)/sqrt(fan_in) of the
    layer's weight, the torch default at s = 1), ``normal`` (N(0, s)) or
    ``const`` (s); a name no rule matches is ``fan_in`` with s = 1."""
    plan = []
    for name, shape in shapes.items():
        kind, scale = next(((k, s) for suffix, k, s in rules if name.endswith(suffix)),
                           ("fan_in", 1.0))
        plan.append((name, tuple(shape), kind, scale))
    n_uniform = sum(math.prod(s) for _, s, k, _ in plan if k == "fan_in")
    n_normal = sum(math.prod(s) for _, s, k, _ in plan if k == "normal")
    uniform = torch.rand(n_uniform, generator=generator, device=device) * 2 - 1
    normal = torch.randn(n_normal, generator=generator, device=device)
    params, iu, inn = {}, 0, 0
    for name, shape, kind, scale in plan:
        n = math.prod(shape)
        if kind == "fan_in":
            w = shapes[name.rsplit(".", 1)[0] + ".weight"]
            fan_in = math.prod(w[1:])
            params[name] = (uniform[iu:iu + n] * (scale / math.sqrt(fan_in))).reshape(shape)
            iu += n
        elif kind == "normal":
            params[name] = (normal[inn:inn + n] * scale).reshape(shape)
            inn += n
        elif kind == "const":
            params[name] = torch.full(shape, float(scale), device=device)
        else:
            raise ValueError(f"unknown init kind {kind!r}")
    return {k: v.contiguous() for k, v in params.items()}


def seed_generator(seed: int, salt: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * 2 + salt) % (2 ** 63))


class Run:
    """What one run of a cell holds: its files, seed, device, the weights
    and subjects drawn from the seed, and what the window produced."""

    def __init__(self, workload: str, seed: int, device, bench: dict | None = None,
                 root: str = ROOT):
        self.bench = bench if bench is not None else load_benchmark(root)
        self.workload, self.seed, self.device = workload, int(seed), torch.device(device)
        self.cell, self.config, self.traffic = load_cell(self.bench, workload, root)
        self.kind = self.traffic["kind"]
        self.half = self.traffic.get("dataset") == "half"
        self.ref = reference_module(self.config, root)
        self.knobs = dict(self.config["knobs"])

    def draw(self, tmpdir: str):
        """The seed's weights (on the device) and subjects (host arrays,
        also pickled under ``tmpdir`` for the program's loaders)."""
        shapes = self.ref.param_shapes(self.knobs)
        self.params0 = make_params(shapes, self.config["init"], seed_generator(self.seed, 0, self.device),
                                   self.device)
        self.subjects = bdata.make_subjects(self.config["n_subjects"], self.config["volume"],
                                            seed_generator(self.seed, 1, self.device), self.device)
        self.paths = bdata.write_subjects(self.subjects, tmpdir)

    def volume(self, i: int) -> torch.Tensor:
        img = self.subjects[i][0]
        img = img[::2, ::2, ::2] if self.half else img
        return torch.from_numpy(np.ascontiguousarray(img))[None, None].to(self.device)

    def labels(self, i: int) -> torch.Tensor:
        lab = self.subjects[i][1]
        lab = lab[::2, ::2, ::2] if self.half else lab
        return torch.from_numpy(np.ascontiguousarray(lab))[None, None].to(self.device)

    def identify(self, t: torch.Tensor) -> int:
        return bdata.identify(t[0, ..., 0].cpu().numpy(), self.subjects, self.half)


# -- the program's side -------------------------------------------------------------
def _port_config(run: Run):
    from smilecode_tpu_torch.config import InferConfig, TrainConfig

    cfg = TrainConfig() if run.kind == "train" else InferConfig()
    for k, v in run.knobs.items():
        setattr(cfg, k, tuple(v) if isinstance(v, list) else v)
    cfg.dataset = run.traffic.get("dataset", "s2s")
    cfg.device = run.device.type
    cfg.seed = run.seed
    return cfg


def _build(run: Run, cfg):
    from smilecode_tpu_torch.models.registry import build_model

    model = build_model(run.config["model"], cfg, device=run.device)
    model.load_state_dict(run.params0, strict=True)
    return model


STREAM_PASSES = 100  # passes over the subjects' pairs that one Loader pass holds


class _Stream:
    """``dataset``'s pairs, STREAM_PASSES times over: one pass of the
    program's `Loader` covers a whole window, as a deployment's long list of
    pairs does, so its threads never restart inside the window."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset) * STREAM_PASSES

    def __getitem__(self, index):
        return self.dataset[index % len(self.dataset)]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _span(name: str, on: bool):
    if on:
        with torch.profiler.record_function(name):
            yield
    else:
        yield


def _window(run: Run, seconds: float, trace: bool, one) -> dict:
    """Call ``one(traced)`` until ``seconds`` have passed on the host clock.
    Without ``trace`` the whole window runs on the host clock alone; with
    it, the first half does (the per-unit host numbers, free of the
    profiler's own cost) and the second half runs inside the profiler. Each
    part is synchronised at both ends. Returns the host part's seconds and units,
    the traced part's units and the profiler (or None)."""
    def part(until, traced):
        t0, n = time.perf_counter(), 0
        while True:
            one(traced)
            n += 1
            if time.perf_counter() - t0 >= until:
                break
        _sync(run.device)
        return time.perf_counter() - t0, n

    _sync(run.device)
    window_s, units = part(seconds / 2 if trace else seconds, False)
    out = dict(window_s=window_s, units=units, traced_units=0, prof=None)
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if run.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        try:
            with _span("bench.window", True):
                out["traced_units"] = part(seconds - window_s, True)[1]
        finally:
            prof.__exit__(None, None, None)
        out["prof"] = prof
    return out


class _Flows:
    """A forward hook on the program's model that keeps a copy of the flow
    it returns (its second output) while ``on``."""

    def __init__(self, model):
        self.on, self.flows = False, []
        self.handle = model.register_forward_hook(self)

    def __call__(self, module, inputs, outputs):
        if self.on:
            self.flows.append(outputs[1].detach().clone())


def run_train(run: Run, seconds: float, trace: bool, t_start: float) -> dict:
    """Set-up: the training step of `train.make_train_step` over the
    program's `Loader`, driven through its first N_CHECKED_STEPS steps (the
    readings the reference follows, the first step's flow among them); then
    the window, step after step."""
    from smilecode_tpu_torch.data import Compose, Loader, NumpyType, pair_dataset
    from smilecode_tpu_torch.models.registry import loss_plan
    from smilecode_tpu_torch.optim import AMSGrad, poly_lr
    from smilecode_tpu_torch.train import make_train_step

    cfg = _port_config(run)
    model = _build(run, cfg).train()
    optimizer = AMSGrad(model.parameters(), lr=poly_lr(0, cfg.max_epoch, cfg.lr))
    step = make_train_step(model, loss_plan(run.config["model"], cfg), optimizer, list(cfg.weights))
    dataset = pair_dataset(cfg.dataset, run.paths, Compose([NumpyType((np.float32, np.float32))]),
                           False)
    loader = Loader(_Stream(dataset), batch_size=cfg.batch_size, shuffle=True, seed=run.seed,
                    num_workers=run.traffic["num_workers"], device=run.device)

    feed = iter(loader)
    names = dict((p, n) for n, p in model.named_parameters())
    got = {"losses": [], "pairs": []}
    capture = _Flows(model)
    for i in range(N_CHECKED_STEPS):
        x, y = next(feed)
        got["pairs"].append((run.identify(x), run.identify(y)))
        capture.on = i == 0
        loss, _ = step(x, y)
        capture.on = False
        got["losses"].append(float(loss))
        if i == 0:  # the first gradient as AMSGrad got it: mu = (1 - b1) g
            b1 = optimizer.param_groups[0]["b1"]
            got["g1"] = {names[p]: (optimizer.state[p]["mu"] / (1 - b1)).detach().clone()
                         if "mu" in optimizer.state.get(p, {}) else torch.zeros_like(p)
                         for p in model.parameters()}
    got["delta"] = {n: (p.detach() - run.params0[n]).clone() for n, p in model.named_parameters()}
    got["flow1"] = capture.flows.pop().permute(0, 4, 1, 2, 3)
    capture.handle.remove()
    _sync(run.device)
    setup_s = time.perf_counter() - t_start

    waits, state = [], {"failed": 0}

    def one(traced):
        t0 = time.perf_counter()
        with _span("bench.loader_next", traced):
            x, y = next(feed)
        if not traced:
            waits.append(time.perf_counter() - t0)
        with _span("bench.step", traced):
            loss, _ = step(x, y)
            loss = float(loss)
        state["failed"] += not math.isfinite(loss)

    try:
        window = _window(run, seconds, trace, one)
    finally:
        feed.close()
    return dict(setup_s=setup_s, failed=state["failed"], loader_wait_s=waits, readings=got,
                memory_peak_bytes=_peak(run.device), free=[model, optimizer, step], **window)


def sample_requests(seed: int) -> list:
    """The window's requests, drawn from the seed, that the reference checks."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), 7])
    return sorted(int(i) for i in rng.choice(SAMPLE_FROM, N_SAMPLED_PAIRS, replace=False))


def run_register(run: Run, seconds: float, trace: bool, t_start: float) -> dict:
    """Set-up: `infer.make_infer_step` over the program's `Loader` and one
    warm-up pair; then the window: closed loop, one pair at a time, each
    done when its Dice and folding fraction are on the host."""
    from smilecode_tpu_torch.data import Compose, Loader, NumpyType, Seg_norm, pair_dataset
    from smilecode_tpu_torch.infer import make_infer_step

    cfg = _port_config(run)
    model = _build(run, cfg).eval()
    step = make_infer_step(model)
    dataset = pair_dataset(cfg.dataset, run.paths,
                           Compose([Seg_norm(), NumpyType((np.float32, np.int16))]), True)
    loader = Loader(_Stream(dataset), batch_size=1, num_workers=run.traffic["num_workers"],
                    device=run.device)
    feed = iter(loader)
    capture = _Flows(model)
    x, y, xs, ys = next(feed)  # warm-up pair
    [float(v) for v in step(x, y, xs, ys)]
    _sync(run.device)
    setup_s = time.perf_counter() - t_start

    sampled = set(sample_requests(run.seed))
    lat, waits, got, state = [], [], [], {"k": 0, "failed": 0}

    def one(traced):
        k = state["k"]
        t0 = time.perf_counter()
        with _span("bench.loader_next", traced):
            x, y, xs, ys = next(feed)
        t_wait = time.perf_counter() - t0
        capture.on = k in sampled
        with _span("bench.step", traced):
            out = step(x, y, xs, ys)
        with _span("bench.score", traced):
            dice_trans, dice_raw, fold = (float(v) for v in out)
        if not traced:
            waits.append(t_wait)
            lat.append(time.perf_counter() - t0)
        capture.on = False
        state["failed"] += not all(math.isfinite(v) for v in (dice_trans, dice_raw, fold))
        if k in sampled:
            got.append(dict(request=k, x=x, y=y, dice=dice_trans, dice_raw=dice_raw, fold=fold,
                            flow=capture.flows.pop()))
        state["k"] += 1

    try:
        window = _window(run, seconds, trace, one)
    finally:
        feed.close()
        capture.handle.remove()
    return dict(setup_s=setup_s, failed=state["failed"], latencies_s=lat, loader_wait_s=waits,
                readings=got, memory_peak_bytes=_peak(run.device), free=[model, step], **window)


def _peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


# -- the reference's side ---------------------------------------------------------------
def reference_train(run: Run, pairs, ops: Ops, dtype=torch.float32) -> dict:
    """The reference's losses of the steps on ``pairs`` (moving, fixed), its
    first step's flow and first gradient, and its parameters' change after
    the steps; in ``dtype`` (float64: a witness of the float32 sides). The
    loss counts in float64 whatever ``dtype``: in float32 its local NCC
    loses digits to cancellation where a window's variance is small, and
    would be the less accurate side."""
    p = {k: v.detach().to(dtype, copy=True).requires_grad_(True) for k, v in run.params0.items()}
    opt = RefAMSGrad(p)
    lr = ref_poly_lr(0, run.knobs["max_epoch"], run.knobs["lr"])
    out = {"losses": []}
    for i, (xi, yi) in enumerate(pairs):
        x, y = run.volume(xi).to(dtype), run.volume(yi).to(dtype)
        fwd = run.ref.forward(p, ops, run.knobs, x, y)
        if i == 0:
            out["flow1"] = fwd[1].detach().clone()
        outs = [o.double() for o in run.ref.train_outputs(fwd)]
        loss = sum(loss_terms(outs, y.double(), run.knobs["weights"]))
        grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(p[k]))
                 for k, g in zip(p, grads)}
        out["losses"].append(float(loss.detach()))
        if i == 0:
            out["g1"] = {k: g.detach().clone() for k, g in grads.items()}
        del fwd, outs, loss
        opt.step(p, grads, lr)
    out["delta"] = {k: (v.detach() - run.params0[k]) for k, v in p.items()}
    return out


@torch.no_grad()
def reference_register(run: Run, pairs, ops: Ops, dtype=torch.float32) -> list:
    """Flow, Dice (registered and raw) and folding fraction of the
    reference for each (moving, fixed) of ``pairs``, in ``dtype``."""
    params = {k: v.to(dtype) for k, v in run.params0.items()}
    out = []
    for xi, yi in pairs:
        flow = run.ref.forward(params, ops, run.knobs, run.volume(xi).to(dtype),
                               run.volume(yi).to(dtype))[1]
        xs, ys = run.labels(xi), run.labels(yi)
        warped = ops.warp(xs.to(flow.dtype), flow, mode="nearest")
        out.append(dict(flow=flow, dice=ref_dice(warped.round(), ys), dice_raw=ref_dice(xs, ys),
                        fold=ref_fold(flow[0])))
    return out


def _norm(t) -> float:
    return float(t.double().norm())


def _flow_gaps(pairs_of_flows) -> dict:
    """The widest gap of the flow (voxels), at any voxel and axis and
    averaged over them, over (candidate, reference) flows."""
    return {"flow_gap": max(float((c - r).abs().max()) for c, r in pairs_of_flows),
            "flow_mean_gap": max(float((c - r).abs().mean()) for c, r in pairs_of_flows)}


def judge_train(cand: dict, ref: dict, detail: dict | None = None) -> dict:
    """The numbers of a training cell (PERF.md): the first step's flow gaps
    (as `judge_register`'s); the relative gap of the first step's loss, and
    the widest over the steps; per leaf, the gap of
    the first gradient's norm and of the change's norm over the steps, each
    against the larger of the leaf's reference norm and the median leaf's,
    the widest and the median over the leaves. Leaves whose reference
    gradient is under a thousandth of the median leaf's are left out of the
    change (under AMSGrad they move by their rounding alone). ``detail``
    gets each step's loss gap and the leaves that read widest."""
    steps = [abs(c - r) / abs(r) for c, r in zip(cand["losses"], ref["losses"])]
    g_ref = {k: _norm(v) for k, v in ref["g1"].items()}
    g_med = statistics.median(g_ref.values())
    grad = {k: abs(_norm(cand["g1"][k]) - g_ref[k]) / max(g_ref[k], g_med) for k in g_ref}
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    d_ref = {k: _norm(ref["delta"][k]) for k in moved}
    d_med = statistics.median(d_ref.values())
    change = {k: abs(_norm(cand["delta"][k]) - d_ref[k]) / max(d_ref[k], d_med) for k in moved}
    if detail is not None:
        detail.update(step_loss_gaps=steps,
                      widest_grad=sorted(grad.items(), key=lambda kv: -kv[1])[:4],
                      widest_change=sorted(change.items(), key=lambda kv: -kv[1])[:4])
    return {**_flow_gaps([(cand["flow1"], ref["flow1"])]),
            "loss1_gap": steps[0], "loss_gap": max(steps), "grad_gap": max(grad.values()),
            "grad_median_gap": statistics.median(grad.values()),
            "change_gap": max(change.values()),
            "change_median_gap": statistics.median(change.values())}


def judge_register(cand: list, ref: list) -> dict:
    """The widest gap over the sampled pairs of the flow (voxels, at any
    voxel and axis, and averaged over them), of the Dice (registered or
    raw) and of the folding fraction."""
    dice_gap = max(max(abs(c["dice"] - r["dice"]), abs(c["dice_raw"] - r["dice_raw"]))
                   for c, r in zip(cand, ref))
    fold_gap = max(abs(c["fold"] - r["fold"]) for c, r in zip(cand, ref))
    return {**_flow_gaps([(c["flow"], r["flow"]) for c, r in zip(cand, ref)]),
            "dice_gap": dice_gap, "fold_gap": fold_gap}


def program_readings(run: Run, res: dict):
    """(pairs, candidate readings) of the program in the reference's
    layout."""
    if run.kind == "train":
        return res["readings"]["pairs"], res["readings"]
    pairs, cand = [], []
    for g in res["readings"]:
        pairs.append((run.identify(g["x"]), run.identify(g["y"])))
        cand.append(dict(flow=g["flow"].permute(0, 4, 1, 2, 3), dice=g["dice"],
                         dice_raw=g["dice_raw"], fold=g["fold"]))
    return pairs, cand


def reference_readings(run: Run, pairs, ops: Ops, dtype=torch.float32):
    """The reference's readings on ``pairs`` in ``ops``' precision."""
    if run.kind == "train":
        return reference_train(run, pairs, ops, dtype)
    return reference_register(run, pairs, ops, dtype)


def judge(run: Run, pairs, cand, ref, detail: dict | None = None) -> dict:
    """The numbers of ``cand`` against the reference's ``ref``; a pair the
    program's loader fed that is none of the subjects, or none at all,
    gives inf."""
    if not pairs or any(i < 0 for pair in pairs for i in pair):
        keys = ("flow_gap", "flow_mean_gap") + (
            ("loss1_gap", "loss_gap", "grad_gap", "grad_median_gap", "change_gap",
             "change_median_gap") if run.kind == "train" else ("dice_gap", "fold_gap"))
        return {k: math.inf for k in keys}
    return judge_train(cand, ref, detail) if run.kind == "train" else judge_register(cand, ref)


def checks(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} of each number that ``limits`` holds."""
    return {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}


def is_correct(checked: dict) -> bool:
    return bool(checked) and all(c["value"] <= c["limit"] for c in checked.values())


# -- work counted from the configuration's shapes ---------------------------------------------
def counted_work(run: Run) -> dict:
    """The reference's convolution and linear operations a step or pair
    (`FlopCounterMode`, forward, and backward in a training cell, on the
    meta device, the loss's own left out) and its kernel calls, from the
    configuration's shapes alone."""
    from torch.utils.flop_counter import FlopCounterMode

    from bench_port import work

    size = [s // 2 for s in run.config["volume"]] if run.half else list(run.config["volume"])
    train = run.kind == "train"
    calls = []
    ops = Ops(calls=calls)
    with torch.device("meta"):
        p = {k: torch.empty(s).requires_grad_(train)
             for k, s in run.ref.param_shapes(run.knobs).items()}
        x, y = torch.empty(1, 1, *size), torch.empty(1, 1, *size)
        with FlopCounterMode(display=False) as counter, torch.set_grad_enabled(train):
            outs = run.ref.forward(p, ops, run.knobs, x, y)
            if train:
                outs = run.ref.train_outputs(outs)
                torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])
    flops = counter.get_total_flops()
    kernel_ops = sum(work.call_work(c)[2] for c in calls)
    return {"flops": flops + kernel_ops, "kernel_calls": calls}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


# -- one run ----------------------------------------------------------------------------
def precision(config: dict) -> None:
    """Set the precision that ``config`` states, as the program's drivers
    set it: the reference and the control support float32 with TF32 off
    alone, so a configuration that states another is refused."""
    if config["dtype"] != "float32" or config["tf32"]:
        raise ValueError(f"{config['name']}: dtype {config['dtype']!r}, tf32 {config['tf32']!r}; "
                         "the benchmark's reference and control are float32 with TF32 off")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def measure(run: Run, seconds: float, trace: bool, t_start: float) -> dict:
    """Set-up and the window of ``run`` in its configuration's precision;
    the program's model, optimizer and step are freed on return."""
    precision(run.config)
    with tempfile.TemporaryDirectory(prefix="bench_port_") as tmp:
        run.draw(tmp)
        loop = run_train if run.kind == "train" else run_register
        res = loop(run, seconds, trace, t_start)
    del res["free"]
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return res


def execute(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
            t_start: float | None = None, bench: dict | None = None, root: str = ROOT,
            stderr=None) -> dict:
    """One run of ``workload``; returns the result line's object (with
    ``device`` for a CUDA device)."""
    t_start = time.perf_counter() if t_start is None else t_start
    run = Run(workload, seed, device, bench, root)
    res = measure(run, seconds, trace, t_start)

    t_metrics = time.perf_counter()
    prof = res.pop("prof")
    record = dict(kind=run.kind, config=run.config, **res)
    if trace:
        from bench_port import trace as btrace

        record.update(btrace.reduce(prof))
        record["work"] = counted_work(run)
    del prof
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(run.bench, workload, section):
        value = reader(m["name"], root)(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t_ref = time.perf_counter()
    pairs, cand = program_readings(run, res)
    ok = pairs and all(i >= 0 for pair in pairs for i in pair)
    numbers = judge(run, pairs, cand, reference_readings(run, pairs, Ops()) if ok else None)
    if stderr is not None:
        traced = (f", traced {record['traced_s']:.1f} s at "
                  f"{1e3 * record['traced_s'] / max(res['traced_units'], 1):.2f} ms a unit"
                  if trace else "")
        print(f"phases: set-up {res['setup_s']:.1f} s, window {res['window_s']:.1f} s at "
              f"{1e3 * res['window_s'] / res['units']:.2f} ms a unit{traced}, "
              f"trace and metrics {t_ref - t_metrics:.1f} s, reference "
              f"{time.perf_counter() - t_ref:.1f} s", file=stderr)
    checked = checks(numbers, load_limits(workload, root))
    out = {"correct": is_correct(checked) and res["failed"] == 0,
           "attempted": res["units"] + res["traced_units"],
           "failed": res["failed"], "metrics": metrics}
    if run.device.type == "cuda":
        out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
                         "count": int(run.cell["chips"]),
                         "memory_peak_bytes": res["memory_peak_bytes"],
                         "card": power_limit()}
        if trace:
            out["device"].update(busy_s=record["busy_s"], window_s=record["traced_s"])
    if trace:
        out["breakdown"] = record["breakdown"]
    out["checks"] = checked
    return out
