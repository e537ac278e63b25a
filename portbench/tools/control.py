"""The readings that set a cell's limits, on the chip at the cell's own
size (not run by the benchmark's runs):

    python3 portbench/tools/control.py --workload <cell> --seeds 1 2 3 \\
        [--readings sound control faults] [--seconds 2]

Every reading is a run of the cell through the harness's own
`harness.execute` and verdict, with a short window (the training cells'
loop runs on to the check's last step whatever the window): ``sound``,
the program as it is; ``control``, the program with the nearest
precision below the configuration's in its place (`faults.tf32_products`
for training, `faults.bf16_table` for serving); ``faults``, each fault of
`portbench.faults` the cell can have, planted in the program;
``witness`` (training), the reference against itself summed in another
order.  A step that returns its state unchanged reads 1 by the training
measure and is not run.  One JSON line per reading: its ``correct`` and
each number compared."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import faults, harness  # noqa: E402
from portbench.drivers import train as train_driver  # noqa: E402
from portbench.generator import TokenStream  # noqa: E402
from portbench.reference import steps as ref_steps  # noqa: E402


def reading(cell, seed, dev, seconds, name, plant=None, *args):
    p = faults.Patches()
    if plant is not None:
        plant(p, *args)
    try:
        out, res = harness.execute(harness.Run(
            cell, seed, seconds, False, dev, time.perf_counter()))
    finally:
        p.undo()
    torch.cuda.empty_cache()
    print(json.dumps(dict(
        cell=cell.name, seed=seed, reading=name, correct=res["correct"],
        numbers={k: v["value"] for k, v in res["checks"].items()},
        metrics={k: v["value"] for k, v in res["metrics"].items()},
        detail=out.detail)), flush=True)


def witness(cell, seed, dev):
    """The reference against itself with its loss taken 512 positions at
    a time in place of 1024 (the same sums in another order), read by the
    cell's numbers: how far rounding alone carries the steps the check
    follows."""
    cfg, t = cell.config, cell.traffic
    B, S, lr = cfg["train"]["batch"], t["seq"], cfg["train"]["lr"]
    from repro_torch.train.loop import LoopConfig
    n, rows_at = train_driver.checked_steps(
        LoopConfig(**t.get("loop", {})).plan_every)
    stream = TokenStream(cfg["vocab_size"], t["dist"], t.get("zipf_a", 1.1),
                         seed)
    batches = [(x, np.roll(x, -1, axis=1))
               for x in (stream.tokens((B, S)) for _ in range(n))]
    run = dict(change_after=train_driver.CHANGE_AFTER, rows_at=rows_at)
    ref, init = ref_steps.train(cfg, seed, batches, lr, dev, **run)
    alt, _ = ref_steps.train(cfg, seed, batches, lr, dev, chunk=512, **run)
    print(json.dumps(dict(
        cell=cell.name, seed=seed, reading="witness_chunk512",
        numbers=train_driver.compare(alt, ref, init,
                                     [x for x, _ in batches]),
        loss_gaps=[train_driver.gap(a, b, 0.0)
                   for a, b in zip(alt.losses, ref.losses)])), flush=True)
    del ref, alt, init
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--readings", nargs="+",
                    default=["sound", "control", "faults"])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    harness.set_environment()
    cell = harness.find_cell(args.workload, harness.spec())
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.empty(1, device=dev)
    train = cell.traffic["kind"] == "train"
    for seed in args.seeds:
        for what in args.readings:
            if what == "sound":
                reading(cell, seed, dev, args.seconds, "sound")
            elif what == "control":
                reading(cell, seed, dev, args.seconds,
                        *(("control_tf32", faults.tf32_products) if train
                          else ("control_bf16", faults.bf16_table)))
            elif what == "witness":
                witness(cell, seed, dev)
            elif train:
                for f in faults.TRAIN[1:]:
                    reading(cell, seed, dev, args.seconds, f.__name__, f)
            else:
                reading(cell, seed, dev, args.seconds, "answer_altered",
                        faults.answer_altered,
                        cell.traffic["keys_per_request"])


if __name__ == "__main__":
    main()
