"""The readings that a cell's correctness limits are set from.

    python3 portbench/control.py --workload <name> --seeds 1,2,... \
        --control-seeds 1,2,3 --seconds 3

For each seed, in one process: the cell's table made from the seed, the
warm-up, a short window of the timed loop at the cell's own load, and the
numbers `correct` compares over the sampled tasks (the program's
readings). On the control seeds the same sampled partitions are compared
once more with the control in the program's place: the reference
computed in float32, the precision below the configuration's float64. One
JSON line a seed. The benchmark's own runs never run the control.
"""

import argparse
import json
import random
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    dev = harness.card_or_none(cell)
    if dev is None:
        return 2
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        prep = harness.prepare(cell, seed, dev)
        win = prep.window(args.seconds,
                          int(cell.traffic.get("sample_tasks", 3)),
                          random.Random(seed))
        sample = win.answers()
        line = {"workload": cell.name, "seed": seed,
                "tasks": len(win.tasks),
                "sampled_partitions": [t.partition for t, _ in sample],
                "program": harness.check(prep, sample)}
        if seed in controls:
            line["control"] = harness.check(prep, sample, control=True)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        prep.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
