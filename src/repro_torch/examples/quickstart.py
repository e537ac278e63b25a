"""Quickstart: the paper's mechanism in 60 seconds (the twin of
`examples/quickstart.py`).

1. Simulate an 8-node cluster training a KGE-like sparse workload under
   AdaPM and the standard baselines (paper Figure 1 / Figure 6 in
   miniature).  The simulated times come from `core.api.CostModel`, not
   from a device.
2. Run a few training steps of a real (reduced) LM with intent-managed
   embeddings: the data loader signals intent, the planner replicates the
   multi-shard-hot rows, training runs with the managed lookup, on the
   card unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
"""

from __future__ import annotations

import argparse

from repro_torch.core.api import CostModel
from repro_torch.core.baselines import (StaticFullReplication,
                                        StaticPartitioning)
from repro_torch.core.manager import AdaPM
from repro_torch.core.simulator import (SimConfig, simulate,
                                        single_node_epoch_time)
from repro_torch.data.workloads import make_workload


def part1_cluster_simulation(nodes: int = 8, scale: float = 0.5) -> dict:
    """Returns each policy's `Metrics` by name, and the single-node epoch
    time under ``"single_node"``."""
    print("=" * 64)
    print("Part 1: AdaPM vs standard parameter management (simulated)")
    print("=" * 64)
    cost = CostModel()
    wl = make_workload("KGE", n_nodes=nodes, wpn=4, scale=scale)
    t1 = single_node_epoch_time(wl, cost)
    print(f"single-node epoch: {t1*1e3:.1f} ms (shared memory)")
    out = {"single_node": t1}
    for policy in (AdaPM(nodes, cost),
                   StaticFullReplication(nodes, cost, wl.n_keys),
                   StaticPartitioning(nodes, cost)):
        m = simulate(policy, wl, SimConfig(signal_offset=100))
        out[policy.name] = m
        print(f"{policy.name:22s} speedup {t1/m.epoch_time:5.2f}x   "
              f"remote {m.remote_fraction*100:5.2f}%   "
              f"staleness {m.mean_staleness*1e3:6.2f} ms   "
              f"{m.bytes_per_node/1e6:7.1f} MB/node")
    print("-> AdaPM: near-zero remote accesses, low staleness, no tuning.\n")
    return out


def part2_intent_managed_training(device: str = "cuda", steps: int = 20):
    print("=" * 64)
    print("Part 2: intent-managed embeddings in a real training loop")
    print("=" * 64)
    from repro_torch.configs.registry import get_config
    from repro_torch.train.loop import LoopConfig, train_loop

    cfg = get_config("smollm-135m", smoke=True)
    res = train_loop(cfg, LoopConfig(steps=steps, batch=4, seq=32, pm=True,
                                     cache_capacity=128, n_shards=4,
                                     log_every=5), device=device)
    print(f"-> loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f} over "
          f"{len(res.losses)} steps; {res.plans} placement plans; "
          f"{res.recompiles} compiled miss-capacity buckets")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nodes", type=int, default=8,
                    help="simulated nodes of part 1")
    ap.add_argument("--scale", type=float, default=0.5,
                    help="share of each worker's batches simulated")
    ap.add_argument("--steps", type=int, default=20,
                    help="training steps of part 2")
    ap.add_argument("--device", default="cuda",
                    help="torch device of part 2 (default: cuda)")
    args = ap.parse_args(argv)
    part1_cluster_simulation(args.nodes, args.scale)
    part2_intent_managed_training(args.device, args.steps)


if __name__ == "__main__":
    main()
