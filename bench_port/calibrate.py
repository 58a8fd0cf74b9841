"""Readings that set a cell's limits: the program's numbers over many seeds
and the control's over a few, in one process.

    python3 bench_port/calibrate.py --workload <name> --first-seed <n> --seeds 12 \
        --control-seeds 3 --seconds <s> [--out chiprun_out/calibrate.jsonl]

For each seed, as a run of `run.py` does: weights and subjects from the
seed, set-up and a short window at the cell's own load through the
program, then the float32 reference on the same pairs and the numbers
compared. For the first ``--control-seeds`` seeds also the control: the
reference in the program's place with every convolution and linear layer
of the model computed on TF32-rounded operands (the precision below the
configuration's float32 with TF32 off), held to the float32 reference by
the same numbers. The limits (``limits/<workload>.json``) lie between the
program's largest reading and the control's smallest (PERF.md). The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def fault(name: str):
    """Plant one of the faults a cell can have in the program, underneath
    the harness: ``unchanged`` (AMSGrad's step leaves the state as it is),
    ``loss`` (the training step's loss reported x1.01), ``flow`` (one
    voxel's displacement +1 where the model produces it), ``dice`` (the
    infer step's Dice +0.01)."""
    from smilecode_tpu_torch import infer, optim, train
    from smilecode_tpu_torch.models.modet import ModeT
    from smilecode_tpu_torch.models.rdn import RDN

    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if name == "unchanged":
        def no_update(self, closure=None):
            self.count += 1
        patch(optim.AMSGrad, "step", no_update)
    elif name == "loss":
        make = train.make_loss_and_grads

        def altered(*args, **kwargs):
            fn = make(*args, **kwargs)

            def loss_and_grads(x, y):
                loss, vals = fn(x, y)
                return loss * 1.01, vals
            return loss_and_grads
        patch(train, "make_loss_and_grads", altered)
    elif name == "flow":
        for cls in (ModeT, RDN):
            def altered(self, *args, _forward=cls.forward, **kwargs):
                outs = _forward(self, *args, **kwargs)
                flow = outs[1].clone()
                flow[:, 3, 3, 3, 0] += 1.0
                return (outs[0], flow, *outs[2:])
            patch(cls, "forward", altered)
    elif name == "dice":
        dice = infer.dice_val_voi
        patch(infer, "dice_val_voi", lambda *a, **k: dice(*a, **k) + 0.01)
    else:
        raise ValueError(f"unknown fault {name!r}")
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)


def plain_readings(run, pairs) -> list:
    """A second witness: the program's own plain route (its PyTorch
    versions of the kernels, ``attn_impl="plain"``) on the same pairs."""
    import torch

    from bench_port import harness
    from bench_port.reference.common import Ops
    from bench_port.reference.train import dice, fold_fraction
    from smilecode_tpu_torch.models.registry import build_model

    cfg = harness._port_config(run)
    cfg.attn_impl = "plain"
    model = build_model(run.config["model"], cfg, device=run.device)
    model.load_state_dict(run.params0, strict=True)
    model.eval()
    out = []
    with torch.no_grad():
        for xi, yi in pairs:
            x, y = (run.volume(i).permute(0, 2, 3, 4, 1) for i in (xi, yi))
            flow = model(x, y)[1].permute(0, 4, 1, 2, 3)
            xs, ys = run.labels(xi), run.labels(yi)
            warped = Ops().warp(xs.float(), flow, mode="nearest")
            out.append(dict(flow=flow, dice=dice(warped.round(), ys), dice_raw=dice(xs, ys),
                            fold=fold_fraction(flow[0])))
    return out


def plain_train_readings(run, pairs) -> dict:
    """A second witness for training: the program's plain route
    (``attn_impl="plain"``) through `train.make_train_step` on the same
    pairs, read as the harness reads the program."""
    import torch

    from bench_port import harness
    from smilecode_tpu_torch.models.registry import build_model, loss_plan
    from smilecode_tpu_torch.optim import AMSGrad
    from smilecode_tpu_torch.train import make_train_step

    cfg = harness._port_config(run)
    cfg.attn_impl = "plain"
    model = build_model(run.config["model"], cfg, device=run.device).train()
    model.load_state_dict(run.params0, strict=True)
    opt = AMSGrad(model.parameters(), lr=cfg.lr)
    step = make_train_step(model, loss_plan(run.config["model"], cfg), opt, list(cfg.weights))
    out = {"losses": []}
    capture = harness._Flows(model)
    for i, (xi, yi) in enumerate(pairs):
        capture.on = i == 0
        loss, _ = step(*(run.volume(j).permute(0, 2, 3, 4, 1) for j in (xi, yi)))
        capture.on = False
        out["losses"].append(float(loss))
        if i == 0:
            out["g1"] = {n: (opt.state[p]["mu"] / 0.1).detach().clone()
                         for n, p in model.named_parameters()}
    out["delta"] = {n: (p.detach() - run.params0[n]) for n, p in model.named_parameters()}
    out["flow1"] = capture.flows.pop().permute(0, 4, 1, 2, 3)
    capture.handle.remove()
    del model, opt, step
    torch.cuda.empty_cache()
    return out


def readings(workload: str, seed: int, seconds: float, control: bool, device="cuda",
             bench=None, root=None, witness: bool = False, float64: bool = False) -> dict:
    """The program's numbers on ``seed``; with ``control`` the control's,
    and whether the cell's limits pass it; with ``witness`` the program's
    plain route's; with ``float64`` the program's and the float32
    reference's, each against the reference in float64 (which side carries
    a gap)."""
    import torch

    from bench_port import harness
    from bench_port.reference.common import Ops

    root = root or harness.ROOT
    t0 = time.perf_counter()
    run = harness.Run(workload, seed, device, bench, root)
    res = harness.measure(run, seconds, False, t0)
    pairs, cand = harness.program_readings(run, res)
    ref = harness.reference_readings(run, pairs, Ops())
    out = {"workload": workload, "seed": seed, "units": res["units"], "setup_s": res["setup_s"],
           "window_s": res["window_s"], "program": harness.judge(run, pairs, cand, ref)}
    if control:
        ctl = harness.reference_readings(run, pairs, Ops(tf32=True))
        out["control"] = harness.judge(run, pairs, ctl, ref)
        out["control_correct"] = harness.is_correct(
            harness.checks(out["control"], harness.load_limits(workload, root)))
    if witness:
        plain = (plain_train_readings if run.kind == "train" else plain_readings)(run, pairs)
        out["witness"] = harness.judge(run, pairs, plain, ref)
    if float64:
        ref64 = harness.reference_readings(run, pairs, Ops(), torch.float64)
        for side, got in (("program", cand), ("reference", ref)):
            detail = {}
            out[f"{side}_vs_float64"] = harness.judge(run, pairs, got, ref64, detail)
            out[f"{side}_vs_float64_detail"] = detail
    if run.kind == "train":
        detail = {}
        harness.judge(run, pairs, cand, ref, detail)
        out["detail"] = detail
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default="")
    ap.add_argument("--fault", default="", help="plant a fault in the program (see `fault`)")
    ap.add_argument("--witness", action="store_true",
                    help="also the program's plain route on the same pairs")
    ap.add_argument("--float64", action="store_true",
                    help="also the reference in float64 as a witness of both float32 sides")
    args = ap.parse_args(argv)
    sys.path.insert(0, CHECKOUT)
    rows = []
    for i in range(args.seeds):
        with fault(args.fault) if args.fault else contextlib.nullcontext():
            row = readings(args.workload, args.first_seed + i, args.seconds,
                           i < args.control_seeds, witness=args.witness and i < args.control_seeds,
                           float64=args.float64)
        row["fault"] = args.fault or None
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    for name in rows[0]["program"]:
        lower = max(r["program"][name] for r in rows)
        median = sorted(r["program"][name] for r in rows)[len(rows) // 2]
        ctl = [r["control"][name] for r in rows if "control" in r]
        print(f"{args.workload} {name}: program max {lower!r} (median {median!r}) over "
              f"{len(rows)} seeds; "
              f"control min {min(ctl) if ctl else None!r} over {len(ctl)} seeds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
