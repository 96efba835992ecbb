"""Readings that the limits of `correct` are set from.

    python3 -m bench.calibrate --workload arxiv-sgc.seg500 --seeds 3,5,8 --seconds 8

For each seed one run of the cell, in this one process, at the cell's own
sizes and load with a short window, and one JSON line: the program's
numbers, and over the same batches those of stand-ins put in the
program's place:

* ``control``: the reference in float32 with TF32, one precision below
  the float32 with TF32 off that the configurations state;
* ``step_unchanged``: the reference with its first propagation step
  returning its input;
* ``half_support``: the reference with the stationary state's mean taken
  over half of each support (the batch and every other support node);
* ``answer_altered``: the reference's answers with one class per batch
  moved on by one.

The benchmark's own runs read none of them.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench import harness  # noqa: E402


def _answers(r):
    return r.orders, r.logits[r.orders - 1, np.arange(len(r.orders))].argmax(1)


def stand_ins(built: dict) -> dict:
    low = harness.reference(built, dtype=torch.float32, tf32=True)
    stuck = harness.reference(built)
    stuck.series = torch.cat([stuck.series[:1], stuck.series[:-1]])
    half = harness.reference(built)
    full_mask = half.support_mask

    def half_mask(nodes):
        m = full_mask(nodes)
        keep = torch.nonzero(m)[:, 0]
        m2 = half.g.mask(nodes)
        m2[keep[::2]] = True
        return m2
    half.support_mask = half_mask
    n_cls = built["cfg"].num_classes

    def altered(uniq, out):
        orders, preds = _answers(out)
        preds = preds.copy()
        preds[0] = (preds[0] + 1) % n_cls
        return orders, preds
    return {"control": lambda u, out: _answers(low.batch(u)),
            "step_unchanged": lambda u, out: _answers(stuck.batch(u)),
            "half_support": lambda u, out: _answers(half.batch(u)),
            "answer_altered": altered}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = harness.run_cell(cell, seed, args.seconds, False,
                               device=args.device, stand_ins=stand_ins)
        print(json.dumps(dict(
            workload=args.workload, seed=seed, correct=out["correct"],
            program={k: v for k, (v, _) in out["checks"].items()},
            **out["stand_ins"], compared=out["compared"],
            attempted=out["attempted"], failed=out["failed"],
            metrics={k: v["value"] for k, v in out["metrics"].items()},
            seconds=time.perf_counter() - t)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
