"""Hopper kernels of the port. Building and loading happen at the first
launch (`_build.library`), never at import.

`kernel_switch` is the one parse of a model's ``attn_impl``: "auto" runs
the kernels (each wrapper: its kernel for CUDA tensors, its plain version
for CPU tensors), "plain" their plain versions; `ops.blocks.mark_model_`
sets the bool as ``kernels`` on every submodule, where the ops read it.
`launch_counters` is the inventory: every kernel's counters, K1-K8.
"""

from __future__ import annotations


def kernel_switch(attn_impl: str) -> bool:
    """True for ``attn_impl`` "auto" (the Hopper kernels), False for
    "plain" (their plain PyTorch versions); ValueError for anything else."""
    if attn_impl not in ("auto", "plain"):
        raise ValueError(f"attn_impl must be 'auto' or 'plain', got {attn_impl!r}")
    return attn_impl == "auto"


def _wrappers() -> dict:
    """{kernel: the wrapper function that carries its counters}."""
    from smilecode_tpu_torch.kernels import (
        conv3d_wgrad,
        correlation3d,
        layer_norm,
        modet_attn,
        warp3d,
    )

    return {"K1": modet_attn.modet_attention, "K3": modet_attn.modet_attention_bwd_dq,
            "K4": modet_attn.modet_attention_bwd_dk, "K2": warp3d.warp3d_trilinear,
            "K5": warp3d.warp3d_trilinear_bwd, "K6": conv3d_wgrad.conv3d_wgrad,
            "K7": correlation3d.correlation3d, "K8": layer_norm.layer_norm}


def _is_counter(name: str) -> bool:
    return name.startswith(("launches", "scatters", "declined"))


def launch_counters() -> dict:
    """Every counter of the kernel wrappers K1-K8 in this process
    (``"K1 launches"``, ``"K1 launches_halo"``, ``"K5 scatters_origin"``,
    ``"K6 launches"``, ``"K6 declined"``: float32 weight gradients on the
    card that went to cuDNN because of their shape, ``"K7 launches"``: PR++'s
    correlations and their adjoints, ``"K8 launches"``: ModeT's LayerNorms and
    their backwards, ...)."""
    return {f"{key} {name}": int(value) for key, fn in _wrappers().items()
            for name, value in sorted(vars(fn).items()) if _is_counter(name)}


def reset_launch_counters() -> None:
    """Set every counter of `launch_counters` to zero."""
    for fn in _wrappers().values():
        for name in [n for n in vars(fn) if _is_counter(n)]:
            setattr(fn, name, 0)
