"""Run one cell of the port's benchmark once.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with the plain reference beside its limit, which also end
standard error. Exits non-zero, printing no result, without a CUDA card
(or with fewer than the cell asks for), and when JAX or the JAX package
was loaded into the process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _finite(obj):
    """``obj`` with every non-finite float written as a string (JSON has no
    infinity)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, CHECKOUT)
    import torch

    from bench_port import harness

    chips = int(harness.load_cell(harness.load_benchmark(), args.workload)[0]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: the cell needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.execute(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                          t_start=T_START, stderr=sys.stderr)
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"bench_port: the run loaded {found}; the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
