"""The training entry point: ``python -m repro_torch.launch.train --arch
qwen3-moe-30b-a3b ...`` (the twin of `repro/launch/train.py`, with its
flags, plus ``--device``).

Runs on the card unless ``--device cpu`` is given.  The reduced
(``--smoke``) configs are the default; ``--full`` takes the published
config.  ``--kernel`` routes the managed embedding's lookup and update
through the hand-written kernels.
"""

from __future__ import annotations

import argparse

from repro_torch.configs.registry import ARCH_IDS, PORT_ONLY, get_config
from repro_torch.pm.controller import AUTO
from repro_torch.train.loop import LoopConfig, train_loop


def _auto_or_int(v: str):
    """Knob flag value: ``auto`` (controller-managed, the default) or an
    explicit integer pin."""
    return AUTO if v == AUTO else int(v)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS + tuple(PORT_ONLY),
                    default="smollm-135m")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced config (CPU-runnable); default on")
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="the published config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--optimizer", choices=("adagrad", "adam"),
                    default="adagrad")
    ap.add_argument("--no-pm", dest="pm", action="store_false",
                    help="disable intent-managed embeddings")
    ap.add_argument("--kernel", action="store_true",
                    help="hand-written kernels on the managed hot path "
                         "(their plain versions on the CPU)")
    ap.add_argument("--cache-capacity", type=_auto_or_int, default=AUTO,
                    help="replica-cache rows, or 'auto' (default): steered "
                         "by intent demand over power-of-two buckets")
    ap.add_argument("--shards", type=int, default=4,
                    help="logical data shards for intent aggregation")
    ap.add_argument("--refresh-every", type=_auto_or_int, default=AUTO,
                    help="replica sync cadence in steps (0: replans only), "
                         "or 'auto' (default): hill-climbed on measured "
                         "loss-drop/s")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--init-from", default=None,
                    help="checkpoint to restore from: a step_* directory "
                         "or a --ckpt-dir root (newest step is used)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write per-phase spans (signal/plan/refresh/step) "
                         "as Chrome trace-event JSON to PATH")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    lc = LoopConfig(steps=args.steps, batch=args.batch, seq=args.seq,
                    lr=args.lr, optimizer=args.optimizer, pm=args.pm,
                    kernel=args.kernel,
                    cache_capacity=args.cache_capacity,
                    n_shards=args.shards,
                    refresh_every=args.refresh_every,
                    ckpt_dir=args.ckpt_dir,
                    ckpt_every=args.ckpt_every, init_from=args.init_from)
    tracer = None
    if args.trace:
        from repro_torch.obs.trace import SpanTracer
        tracer = SpanTracer()
    res = train_loop(cfg, lc, tracer=tracer, device=args.device)
    if tracer is not None:
        tracer.dump(args.trace)
        from repro_torch.obs.report import render_report
        print(render_report(tracer.to_chrome()["traceEvents"],
                            title="train shutdown report"))
        print(f"trace: {args.trace} ({tracer.count} spans, "
              f"{tracer.dropped} dropped)")
    print(f"done: {len(res.losses)} steps, final loss "
          f"{res.losses[-1]:.4f}, {res.plans} placement plans, "
          f"{res.refreshes} replica refreshes, {res.overflows} overflow "
          f"fallbacks, {res.recompiles} compiled buckets, "
          f"{res.capacity_resizes} capacity resizes, "
          f"knobs {res.knobs}, {res.wall_s:.1f}s wall")


if __name__ == "__main__":
    main()
