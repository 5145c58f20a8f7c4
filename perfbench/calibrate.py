"""The readings that a cell's limits are set from, in one process.

    python3 perfbench/calibrate.py --workload <cell> --first-seed <s> \
        [--seeds 12] [--control-seeds 3] [--out <file.json>]

Builds the cell's program once.  For each of ``--seeds`` seeds it solves
the seed's first ``sample`` right-hand side blocks (the blocks a run's
window starts with) through the program and judges them as a run does
(``check.compare``): the lower readings.  Then, with the program freed,
the control takes the program's place on ``--control-seeds`` further seeds:
the plain reference at the precision the configuration names under
``control`` (one step below its own), judged the same way: the upper
readings.  Prints a table and the largest sound and smallest control
reading of each number; ``--out`` keeps them as JSON.  Needs the card,
like ``run.py``; the benchmark's own runs never run the control.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seeds, device, *, control=False, log=sys.stderr):
    """{seed: {name: [value, limit]}} of the program (or, with ``control``, of the
    reference at the control precision in its place)."""
    import torch

    from perfbench import check
    from perfbench.rhs import RhsStream

    config = cell.config
    matrix = cell.module("matrices").generate(config)
    reference = cell.module("reference")
    k = int(cell.check["sample"])
    dtype = getattr(torch, config["dtype"])
    if control:
        solver_op = reference.operator(matrix, device, config["control"])

        def solve(b):
            return reference.solve(solver_op, b, config, config["control"])
    else:
        system = cell.module("systems").System(matrix, config, device, {})
        solve = system.solve
    samples = {}
    for seed in seeds:
        stream = RhsStream(cell.traffic, matrix[0][0], seed, device, dtype)
        kept, failed = {}, 0
        for i in range(k):
            res = solve(stream.rhs(i))
            failed += not check.solve_ok(res)
            kept[i] = (res.x, res.iterations)
        samples[seed] = (stream, kept, failed)
    solve = system = solver_op = None
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    op = reference.operator(matrix, device)
    out = {}
    for seed, (stream, kept, failed) in samples.items():
        out[seed] = {name: [value, limit] for name, value, limit in
                     check.compare(reference, op, config, cell.check, kept,
                                   stream.rhs, failed)}
        print(f"{'control' if control else 'program'} seed {seed}: "
              f"{out[seed]}", file=log, flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--first-seed", type=int, required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import spec

    cell = spec.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("calibrate.py: needs a CUDA card", file=sys.stderr)
        return 1
    t = time.perf_counter()
    seeds = [args.first_seed + 7919 * j for j in range(args.seeds)]
    cseeds = [args.first_seed + 7919 * (args.seeds + j)
              for j in range(args.control_seeds)]
    program = readings(cell, seeds, "cuda")
    control = readings(cell, cseeds, "cuda", control=True)
    names = next(iter(program.values())).keys()
    summary = {n: {"lower": max(r[n][0] for r in program.values()),
                   "upper": min(r[n][0] for r in control.values()),
                   "limit": min(r[n][1] for r in program.values())}
               for n in names}
    result = {"workload": args.workload,
              "device": torch.cuda.get_device_name(),
              "control": cell.config["control"],
              "program": {str(s): r for s, r in program.items()},
              "controls": {str(s): r for s, r in control.items()},
              "summary": summary, "seconds": time.perf_counter() - t}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
