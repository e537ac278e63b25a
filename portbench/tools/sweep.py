"""A serving cell at other offered rates or other settings of the
runtime's knobs, in one process, on the chip (not run by the benchmark's
runs):

    python3 portbench/tools/sweep.py --workload nemotron-serve-zipf \\
        --rates 4000 8000 16000 --seconds 8 --seed 1
    python3 portbench/tools/sweep.py --workload nemotron-serve-uniform \\
        --knobs 16/2 32/2 32/4 --seconds 10 --seed 1

``--rates`` finds an open loop's knee; ``--knobs`` takes
``replan_every/pipeline_depth`` pairs in place of the traffic file's.
One JSON line per run: the cell's end-to-end metric, the latency
percentiles from the due time (open loop), and the median latency of the
window's first and last fifth (a backlog that grows through the window
shows as the last fifth's far above the first's)."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", default=[None])
    ap.add_argument("--knobs", nargs="+", default=[None])
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    harness.set_environment()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.empty(1, device=dev)
    for knobs in args.knobs:
        for rate in args.rates:
            cell = harness.find_cell(args.workload, harness.spec())
            if rate is not None:
                cell.traffic = dict(cell.traffic, rate=rate)
            if knobs is not None:
                replan, depth = (int(x) for x in knobs.split("/"))
                cell.traffic = dict(cell.traffic, serve=dict(
                    cell.traffic.get("serve", {}), replan_every=replan,
                    pipeline_depth=depth))
            out, res = harness.execute(harness.Run(
                cell, args.seed, args.seconds, False, dev,
                time.perf_counter()))
            print(json.dumps(dict(
                rate=rate, set=knobs, correct=res["correct"],
                failed=res["failed"],
                **{k: v["value"] for k, v in res["metrics"].items()},
                **out.detail)), flush=True)


if __name__ == "__main__":
    main()
