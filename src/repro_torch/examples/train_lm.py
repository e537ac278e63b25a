"""End-to-end LM training with intent-managed parameter management
(the twin of `examples/train_lm.py`).

With ``--full`` it trains the real smollm-135m (135M params); the default
smoke profile trains the reduced variant through the identical code path
(intent-signaling loader -> Algorithm-1 planner -> replica-cache refresh
-> managed train step, each layer rematerialised -> checkpointing when
``--ckpt-dir`` is given).  Runs on the card unless ``--device cpu`` is
given.

Examples:
  PYTHONPATH=src python -m repro_torch.examples.train_lm
  PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu
  PYTHONPATH=src python -m repro_torch.examples.train_lm --full \\
      --batch 32 --seq 1024
"""

from __future__ import annotations

import argparse

from repro_torch.configs.registry import get_config
from repro_torch.train.loop import LoopConfig, train_loop


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--full", action="store_true",
                    help="full config (135M params)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--no-pm", dest="pm", action="store_false")
    ap.add_argument("--ckpt-dir", default=None,
                    help="write checkpoints there (none by default)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=not args.full)
    n = cfg.param_count()
    print(f"training {cfg.arch_id} ({'full' if args.full else 'smoke'}): "
          f"{n/1e6:.1f}M params, pm={'on' if args.pm else 'off'}")
    res = train_loop(cfg, LoopConfig(
        steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
        pm=args.pm, cache_capacity=256, n_shards=4,
        ckpt_dir=args.ckpt_dir, ckpt_every=max(50, args.steps // 4),
        log_every=max(1, args.steps // 20)), device=args.device)
    k = max(1, len(res.losses) // 10)
    first = sum(res.losses[:k]) / k
    last = sum(res.losses[-k:]) / k
    print(f"done: loss {first:.3f} -> {last:.3f} "
          f"({len(res.losses)} steps, {res.wall_s:.0f}s, "
          f"{res.plans} plans, {res.recompiles} buckets)")
    return res


if __name__ == "__main__":
    main()
