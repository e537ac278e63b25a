"""Full parameter-management study on the simulated cluster: all five
paper tasks, AdaPM vs tuned/untuned baselines, with the Figure-15-style
per-key management trace (the twin of `examples/pm_simulation.py`).
Host code only: the times, speedups and MB per node are the simulator's
`core.api.CostModel` outputs, not measurements of a device.

Run:  PYTHONPATH=src python -m repro_torch.examples.pm_simulation
      [--task MF] [--nodes 8]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.api import CostModel
from repro_torch.core.baselines import (NuPSStatic, SelectiveReplicationSSP,
                                        StaticFullReplication,
                                        StaticPartitioning)
from repro_torch.core.manager import AdaPM
from repro_torch.core.simulator import (SimConfig, simulate,
                                        single_node_epoch_time)
from repro_torch.data.workloads import TASKS, make_workload


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--task", choices=tuple(TASKS), default="KGE")
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--scale", type=float, default=0.5)
    args = ap.parse_args(argv)

    cost = CostModel()
    wl = make_workload(args.task, n_nodes=args.nodes, wpn=4,
                       scale=args.scale)
    t1 = single_node_epoch_time(wl, cost)
    print(f"task={args.task} nodes={args.nodes} keys={wl.n_keys} "
          f"single-node epoch {t1*1e3:.1f} ms\n")
    print(f"{'policy':28s} {'speedup':>8s} {'remote%':>8s} "
          f"{'MB/node':>8s} {'stale ms':>9s}")

    policies = [
        ("AdaPM (zero tuning)", lambda: AdaPM(args.nodes, cost)),
        ("AdaPM w/o relocation",
         lambda: AdaPM(args.nodes, cost, relocation=False)),
        ("AdaPM w/o replication",
         lambda: AdaPM(args.nodes, cost, replication=False)),
        ("NuPS hot=1% off=64", lambda: NuPSStatic(
            args.nodes, cost, wl.n_keys, wl.hot_keys(0.01), 64)),
        ("NuPS hot=.05% off=512", lambda: NuPSStatic(
            args.nodes, cost, wl.n_keys, wl.hot_keys(0.0005), 512)),
        ("Full replication", lambda: StaticFullReplication(
            args.nodes, cost, wl.n_keys)),
        ("Static partitioning",
         lambda: StaticPartitioning(args.nodes, cost)),
        ("SSP (bound=20)", lambda: SelectiveReplicationSSP(
            args.nodes, cost, 20)),
    ]
    for name, mk in policies:
        m = simulate(mk(), wl, SimConfig(signal_offset=100))
        print(f"{name:28s} {t1/m.epoch_time:8.2f} "
              f"{m.remote_fraction*100:8.3f} "
              f"{m.bytes_per_node/1e6:8.1f} {m.mean_staleness*1e3:9.3f}")

    # Figure-15-style trace of a hot and a cold key
    freq = wl.key_frequencies()
    order = np.argsort(-freq)
    picks = {"hottest": int(order[0]), "warm": int(order[len(order)//50]),
             "cold": int(order[np.nonzero(freq[order])[0][-1]])}
    pol = AdaPM(args.nodes, cost, trace_keys=set(picks.values()))
    simulate(pol, wl, SimConfig(signal_offset=100))
    print("\nper-key management trace (paper Fig. 15):")
    for name, key in picks.items():
        evs = [(round(t*1e3, 1), n, e) for (t, k, n, e) in pol.trace
               if k == key][:12]
        print(f"  {name} (key {key}, {int(freq[key])} accesses): {evs}")


if __name__ == "__main__":
    main()
