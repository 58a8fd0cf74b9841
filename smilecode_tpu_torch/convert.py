"""Weights between the port, the JAX package and reference checkpoints.

* `params_from_state_dict`: a port (or reference) `state_dict` -> JAX-format
  params ``{"params": nested numpy tree}``, the mapping of
  `smilecode_tpu/convert.py:convert_state_dict` without a template.
* `state_dict_from_jax`: JAX params (nested dict of numpy arrays, e.g. from a
  JAX ``.ckpt``) -> a port `state_dict`; the inverse of the above.
* `load_torch_checkpoint`: a reference ``.pth.tar`` straight into a port
  model, dropping the reference's registered ``.grid`` / ``transformer``
  buffers.

Layout rules (torch -> JAX): Conv3d (Cout, Cin, k, k, k) -> (k, k, k, Cin,
Cout); ConvTranspose3d (Cin, Cout, k, k, k) -> (k, k, k, Cin, Cout); Linear
(out, in) -> (in, out); LayerNorm weight -> scale; a numeric Sequential index
merges into its module name (``conv.0`` -> ``conv_0``).

Given the port ``model``, both directions take each 5-D kernel's layout from
its module's type and apply the JAX package's per-family renames
(`RENAMES_BY_MODEL`, keyed by the model's class name). Without it they treat
every 5-D kernel as a Conv3d and rename nothing, which is right for ModeT
only: a square ConvTranspose3d (Cin == Cout, VTN's ``Upsamp*``) has the same
shape in both layouts and would load transposed without an error.
"""

from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch
from torch import nn

# `smilecode_tpu/convert.py:RENAMES_BY_MODEL` (torch path -> JAX path on the
# dotted merged path; the first pattern that changes it wins), keyed by the
# port model's class name. PCNet: ChannelAttention's ``fc`` Sequential ->
# raw ``fc1``/``fc2`` kernels, the single-conv ``weight_conv`` Sequentials ->
# plain convs, ``upconvN.upconv`` -> ``upconvN``, ResBlock's ``block.2`` ->
# ``conv``.
RENAMES_BY_MODEL = {
    "pcnet": (
        (r"fc_0\.kernel$", "fc1"),
        (r"fc_2\.kernel$", "fc2"),
        (r"weight_conv_(\d+)_0\.", r"weight_conv_\1."),
        (r"weight_conv_0\.", "weight_conv."),
        (r"(upconv\d)\.upconv\.", r"\1."),
        (r"\.block_2\.", ".conv."),
    ),
    "vtn": ((r"(Upsamp\dto\d|Pred0)\.upconv\.", r"\1."),),
    "rcn": ((r"(Upsamp\dto\d|Pred0)\.upconv\.", r"\1."),),
}


def torch_key_to_flax_path(key: str) -> tuple[str, ...] | None:
    """Translate one state_dict key to a JAX param path (None for buffers
    that have no param equivalent), as `smilecode_tpu/convert.py` does."""
    if key.endswith(".grid") or ".transformer" in key or key.endswith("num_batches_tracked"):
        return None
    merged = []
    for p in key.split("."):
        if p.isdigit() and merged:
            merged[-1] = f"{merged[-1]}_{p}"
        else:
            merged.append(p)
    *mods, leaf = merged
    if mods and mods[-1] == "norm" and leaf == "weight":
        leaf = "scale"
    elif leaf == "weight":
        leaf = "kernel"
    return tuple(mods) + (leaf,)


def _renamed(path: tuple[str, ...], renames) -> tuple[str, ...]:
    dotted = ".".join(path)
    for pat, repl in renames:
        cand = re.sub(pat, repl, dotted)
        if cand != dotted:
            return tuple(cand.split("."))
    return path


def _param_map(model: nn.Module) -> dict:
    """{state_dict key: (JAX path, is the owner a ConvTranspose3d)} for every
    parameter of ``model``."""
    renames = RENAMES_BY_MODEL.get(type(model).__name__.lower(), ())
    out = {}
    for key, _ in model.named_parameters():
        owner = model.get_submodule(key.rpartition(".")[0])
        out[key] = (_renamed(torch_key_to_flax_path(key), renames),
                    isinstance(owner, nn.ConvTranspose3d))
    return out


def _is_kernel(key: str) -> bool:
    """A weight that takes the kernel layout (named before any rename:
    PCNet's ``fc.0.weight`` is the kernel ``fc1`` in JAX)."""
    return torch_key_to_flax_path(key)[-1] == "kernel"


def params_from_state_dict(state_dict, model: nn.Module | None = None) -> dict:
    """Port `state_dict` -> ``{"params": nested numpy tree}`` (JAX layout).
    Give ``model`` for any model with transposed convolutions or renames."""
    pmap = _param_map(model) if model is not None else None
    tree: dict = {}
    for key, w in state_dict.items():
        path = torch_key_to_flax_path(key)
        if path is None:
            continue
        transposed = False
        if pmap is not None:
            if key not in pmap:
                raise KeyError(f"{key!r} is not a parameter of {type(model).__name__}")
            path, transposed = pmap[key]
        w = w.detach().cpu().numpy()
        if _is_kernel(key) and w.ndim == 5:
            w = w.transpose(2, 3, 4, 0, 1) if transposed else w.transpose(2, 3, 4, 1, 0)
        elif _is_kernel(key) and w.ndim == 2:
            w = w.T
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(w)
    return {"params": tree}


def _module_name(name: str) -> str:
    """Undo the Sequential-index merge: ``conv_0`` -> ``conv.0``. A name whose
    stem ends in a digit (``conv0_1``) was never merged and stays."""
    m = re.fullmatch(r"(.*[A-Za-z])_(\d+)", name)
    return f"{m.group(1)}.{m.group(2)}" if m else name


def state_dict_from_jax(params, model: nn.Module | None = None) -> "OrderedDict[str, torch.Tensor]":
    """JAX params (``{"params": tree}`` or the tree) -> port `state_dict`.
    Give ``model`` for any model with transposed convolutions or renames:
    every leaf must then be one of its parameters, and every parameter must
    be filled."""
    tree = params["params"] if "params" in params else params
    if model is not None:
        return _state_dict_for_model(tree, model)
    out: OrderedDict = OrderedDict()

    def walk(node, prefix):
        for name, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + [_module_name(name)])
                continue
            w = np.asarray(v)
            leaf = name
            if name == "kernel":
                leaf = "weight"
                if w.ndim == 5:
                    w = w.transpose(4, 3, 0, 1, 2)
                elif w.ndim == 2:
                    w = w.T
            elif name == "scale":
                leaf = "weight"
            out[".".join(prefix + [leaf])] = torch.from_numpy(np.ascontiguousarray(w))

    walk(tree, [])
    return out


def _state_dict_for_model(tree, model: nn.Module) -> "OrderedDict[str, torch.Tensor]":
    by_path = {path: (key, transposed) for key, (path, transposed) in _param_map(model).items()}
    out: OrderedDict = OrderedDict()

    def walk(node, prefix):
        for name, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (name,))
                continue
            path = prefix + (name,)
            if path not in by_path:
                raise KeyError(f"JAX param {'/'.join(path)} is not a parameter of "
                               f"{type(model).__name__}")
            key, transposed = by_path[path]
            w = np.asarray(v)
            if w.ndim == 5:
                w = w.transpose(3, 4, 0, 1, 2) if transposed else w.transpose(4, 3, 0, 1, 2)
            elif w.ndim == 2:
                w = w.T
            out[key] = torch.from_numpy(np.ascontiguousarray(w))

    walk(tree, ())
    missing = [key for key, _ in by_path.values() if key not in out]
    if missing:
        raise KeyError(f"parameters of {type(model).__name__} not in the JAX params: "
                       f"{missing[:10]}")
    return out


def load_torch_checkpoint(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a reference ``.pth.tar`` (``{"state_dict": ...}`` or a bare
    state_dict) into ``model``, strictly, after dropping buffer keys."""
    # trusted files named by the user: reference checkpoints hold numpy
    # scalars that the weights-only unpickler refuses
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k: v for k, v in sd.items() if torch_key_to_flax_path(k) is not None}
    model.load_state_dict(sd, strict=True)
    return model
