"""The bf16-vs-f32 flow gap of the JAX package and of the port at
160x192x160, on the inputs and weights of `chip_smoke.py` phase 17, on the CPU.

Phase 17 holds the bf16 forwards to the bf16-vs-f32 gate (mean < 0.06, p99 <
0.3 voxel) at 32^3, where tests/test_modet.py sets it, and at 160x192x160 only
to "the kernels add nothing beyond bf16's own noise". This script measures
what bf16's own noise is at the full size for the JAX package itself: its
bf16 ModeT (kernel A in interpret mode) against the port's float32 forward
(equal to JAX's within 2e-4, tests/test_torch_modet.py), beside the port's
bf16 forward (plain versions). A few minutes and ~10 GB on the CPU:

    JAX_PLATFORMS=cpu python tests/bf16_fullres_gap.py
"""

import os
import sys
import tempfile

import numpy as np
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

import chip_smoke  # noqa: E402
from smilecode_tpu.models import ModeT as JaxModeT  # noqa: E402
from test_torch_modet import jax_params  # noqa: E402


def gap(a, b):
    err = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).ravel()
    return float(err.mean()), float(np.percentile(err, 99))


def main():
    jax.config.update("jax_platforms", "cpu")
    cpu = torch.device("cpu")
    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke.write_subjects(tmp, device=cpu)
        x, y = chip_smoke.forward_pair(tmp, cpu)
    f32 = chip_smoke.excited_model(cpu)
    bf16 = chip_smoke.excited_model(cpu, compute_dtype="bfloat16")
    with torch.no_grad():
        moved32, flow32 = f32(x, y)
        moved16, flow16 = bf16(x, y)
    jm = JaxModeT(qk_scale=1.0, attn_impl="pallas", compute_dtype="bfloat16")
    j_moved, j_flow = jax.jit(jm.apply)(jax_params(f32, chip_smoke.SIZE), jnp.asarray(x.numpy()),
                                        jnp.asarray(y.numpy()))
    print(f"f32 flow max |.| {float(flow32.abs().max()):.4f} voxel")
    for what, flow, moved in (("JAX bf16", j_flow, j_moved), ("port bf16", flow16, moved16)):
        mean, p99 = gap(flow, flow32)
        moved_p99 = float(np.percentile(np.abs(np.asarray(moved) - moved32.numpy()), 99))
        print(f"{what} vs f32: flow endpoint error mean {mean:.4f}, p99 {p99:.4f} voxel; "
              f"moved p99 {moved_p99:.4f}")
    mean, p99 = gap(flow16, j_flow)
    print(f"port bf16 vs JAX bf16: mean {mean:.4f}, p99 {p99:.4f} voxel")


if __name__ == "__main__":
    main()
