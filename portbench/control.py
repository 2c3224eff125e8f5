"""The readings that a cell's limits are set from, on the card.

    python3 -m portbench.control --workload <cell> --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--witness-seeds 1] [--jobs 8] [--diagnose]
        [--out FILE]

For every seed: the jobs that a run's check would sample (of ``--jobs``
jobs) run through the program at the cell's own size, and the numbers the
check compares are read against the plain reference (complex128): the
lower readings.  For every control seed the same numbers are read for the
control in the program's place, the reference computed in TF32
(``reference.tebd``, precision 'tf32'; the driver's ``control_outputs``
where it has one): the upper readings.  For every witness seed they are
read for the reference in complex64 with LAPACK's SVD, the program's own
precision.  With ``--diagnose`` a driver's ``diagnostics`` are reported
beside the program's numbers.  One JSON line per reading, also appended
to ``--out``.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from portbench import run


def readings(name: str, seeds, control_seeds, n_jobs: int, device: str = "cuda",
             root: Path = run.ROOT, emit=print, witness_seeds=(),
             diagnose: bool = False):
    """Yields one dict a reading: seed, side ('program', 'control' or
    'witness'), the check's numbers and the seconds each side took, with
    the driver's ``diagnostics`` beside the program's when ``diagnose``."""
    cell = run.resolve(name, root)
    cls = run.driver_class(cell, root)
    import torch

    for seed in seeds:
        drv = cls(cell, run.seed_words(seed), torch.device(device))
        items = drv.sample(n_jobs)
        t0 = time.perf_counter()
        for j in sorted({j for j, _ in items}):
            drv.job(j, _NoSpans())
        t_prog = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = drv.reference(items)
        t_ref = time.perf_counter() - t0
        got = drv.outputs(items)
        prog = dict(seed=seed, side="program", seconds=t_prog,
                    reference_s=t_ref, **drv.numbers(got, ref))
        if diagnose and hasattr(drv, "diagnostics"):
            prog.update(drv.diagnostics(got, items))
        rows = [prog]
        sides = [("control", "tf32")] if seed in control_seeds else []
        sides += [("witness", "complex64")] if seed in witness_seeds else []
        for side, precision in sides:
            t0 = time.perf_counter()
            if hasattr(drv, "control_outputs"):
                other = drv.control_outputs(items, precision)
            else:
                other = drv.reference(items, precision=precision)
            rows.append(dict(seed=seed, side=side,
                             seconds=time.perf_counter() - t0,
                             **drv.numbers(other, ref)))
        for r in rows:
            emit(r)
            yield r


class _NoSpans:
    def span(self, name):
        import contextlib

        return contextlib.nullcontext()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--witness-seeds", type=int, nargs="*", default=[])
    p.add_argument("--jobs", type=int, default=8)
    p.add_argument("--diagnose", action="store_true")
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    out = open(args.out, "a") if args.out else None

    def emit(r):
        line = json.dumps({"workload": args.workload, **r})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for _ in readings(args.workload, args.seeds, set(args.control_seeds),
                      args.jobs, emit=emit,
                      witness_seeds=set(args.witness_seeds),
                      diagnose=args.diagnose):
        pass
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
