"""The benchmark's plain references against the program's plain path
(its CPU route, no kernels) on one seeded state dict: ModeT at 32^3 and
RDN at 64^3 (stages 2), forward, loss, every gradient and one AMSGrad
update. In float64 on both sides, so that what is left is the program's
own float32 constants (its trilinear fractions are float32 numbers)."""

import pytest
import torch

from bench_port import harness
from bench_port.reference.common import Ops
from bench_port.reference.train import AMSGrad, loss_terms

CASES = {
    "modet": (dict(channels=4, head_dim=6, num_heads=[8, 4, 2, 1, 1], qk_scale=1.0, lr=1e-4,
                   weights=[1.0, 1.0]), (32, 32, 32)),
    "rdn": (dict(channels=16, stages=2, levels=[4, 4, 4, 4], dropout_rate=0.0, lr=1e-4,
                 weights=[1.0, 1.0]), (64, 64, 64)),
}
TOL = 1e-5  # relative to each quantity's largest magnitude
# the program's float32 trilinear fractions move ModeT's gradients by ~1e-5
GRAD_TOL = 1e-4


def _setup(name):
    from smilecode_tpu_torch.config import TrainConfig
    from smilecode_tpu_torch.models.registry import build_model, loss_plan

    knobs, size = CASES[name]
    config = harness._json(f"{harness.ROOT}/configs/{name}-lpba40.json")
    ref = harness.reference_module(config)
    params = harness.make_params(ref.param_shapes(knobs), config["init"],
                                 torch.Generator().manual_seed(11), "cpu")
    params = {k: v.double() for k, v in params.items()}
    cfg = TrainConfig()
    for k, v in knobs.items():
        setattr(cfg, k, v)
    cfg.model, cfg.attn_impl = config["model"], "plain"
    model = build_model(config["model"], cfg, device="cpu").double()
    model.load_state_dict(params, strict=True)
    g = torch.Generator().manual_seed(12)
    fields = torch.rand((2, 1, 1, *[max(2, s // 8) for s in size]), generator=g,
                        dtype=torch.float64)
    x, y = (torch.nn.functional.interpolate(f, size=size, mode="trilinear", align_corners=True)
            for f in fields)
    return ref, knobs, params, model, loss_plan(config["model"], cfg), x, y


def _gap(a, b):
    return float((a - b).detach().abs().max() / b.detach().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_loss_gradients_and_update(name):
    from smilecode_tpu_torch.models.registry import CRITERIA
    from smilecode_tpu_torch.optim import AMSGrad as PortAMSGrad

    ref, knobs, params, model, plan, x, y = _setup(name)
    ndhwc = (x.permute(0, 2, 3, 4, 1), y.permute(0, 2, 3, 4, 1))
    outs = model(*ndhwc)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    routs = ref.forward(p, Ops(), knobs, x, y)
    assert _gap(outs[1].permute(0, 4, 1, 2, 3), routs[1]) < TOL
    assert _gap(outs[0].permute(0, 4, 1, 2, 3), routs[0]) < TOL

    sel = plan.select_train_outputs(outs)
    loss = sum(CRITERIA[c](o, ndhwc[1]) * w for c, o, w in
               zip(plan.criterions, sel, [1.0] * len(sel)))
    rloss = sum(loss_terms(ref.train_outputs(routs), y, knobs["weights"]))
    assert abs(float(loss) - float(rloss)) < TOL * abs(float(rloss))

    loss.backward()
    grads = torch.autograd.grad(rloss, list(p.values()), allow_unused=True)
    named = dict(model.named_parameters())
    for k, g in zip(p, grads):
        g = torch.zeros_like(p[k]) if g is None else g
        assert float((named[k].grad - g).abs().max()) <= GRAD_TOL * float(g.abs().max()) + 1e-12, k

    grads = {k: (torch.zeros_like(p[k]) if g is None else g) for k, g in zip(p, grads)}
    PortAMSGrad(model.parameters(), lr=knobs["lr"]).step()
    AMSGrad(p).step(p, grads, knobs["lr"])
    for k in p:
        # the first update is lr * g / (|g| + eps): an element whose gradient is
        # within the gradients' gap of 0 may move either way, so the elements
        # compared are those with a gradient above 1e-3 of the leaf's largest
        g = grads[k].abs()
        sure = g > 1e-3 * float(g.max())
        gap = (named[k].detach() - p[k].detach()).abs()[sure]
        assert gap.numel() == 0 or float(gap.max()) < 1e-3 * knobs["lr"], k


def test_reference_imports_nothing_of_the_program():
    import ast
    import os

    for name in os.listdir(os.path.join(harness.ROOT, "reference")):
        if name.endswith(".py"):
            with open(os.path.join(harness.ROOT, "reference", name)) as f:
                tree = ast.parse(f.read())
            mods = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
            mods |= {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
            tops = {m.split(".")[0] for m in mods if m}
            assert tops <= {"__future__", "torch", "bench_port"}, (name, tops)
            assert not {m for m in mods if m.startswith("bench_port") and
                        not m.startswith("bench_port.reference")}, name
