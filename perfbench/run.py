"""Run one cell of BENCHMARK.json once, from the root of a checkout:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1> [--control 1]

Prints, as the last line of standard output, one JSON object: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (read by ``metrics/<name>.py`` from the traced
sub-window), ``correct`` from the plain reference, and under
``checks`` (the last key) each number compared with its limit; the same
numbers are the last lines of standard error.  ``--control 1`` also
reads the control (the reference one precision down) and, for training,
the fault of half the batch left out; the benchmark's own runs do not.

Exits non-zero, printing no result, without as many CUDA devices as the
cell asks for, or when JAX or the JAX package has been loaded.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import core  # noqa: E402


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def measure(cell: core.Cell, *, seed: int, seconds: float, trace: bool,
            device, control: bool = False,
            started: float = STARTED) -> dict:
    """Run the cell once on ``device`` and build the result object."""
    import torch

    torch.set_num_threads(4)
    outcome = core.driver_for(cell).run(
        cell, seed=seed, seconds=seconds, trace=trace, device=device,
        started=started, control=control)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = core.read_metric(m["name"], outcome.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": outcome.e2e[m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    result = {"correct": all(c.ok for c in outcome.checks),
              "attempted": outcome.attempted, "failed": outcome.failed,
              "metrics": metrics, "device": outcome.device}
    if outcome.traced is not None:
        result["breakdown"] = outcome.traced["breakdown"]
        outcome.notes["top_kernels"] = outcome.traced["top_kernels"]
    if outcome.control is not None:
        result["control"] = outcome.control
    result["notes"] = outcome.notes
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in outcome.checks}
    return result


def main(argv=None) -> int:
    args = _args(argv)
    import torch

    cell = core.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = measure(cell, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device=torch.device("cuda", 0),
                     control=bool(args.control))
    found = core.forbidden_loaded()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result, default=_plain))
    return 0


def _plain(x):
    """JSON for numpy numbers."""
    return x.item() if hasattr(x, "item") else str(x)


if __name__ == "__main__":
    sys.exit(main())
