"""Batched decode serving across the architecture families (the twin of
`examples/serve_decode.py`).

Prefills a batch of requests, then decodes autoregressively with the
family-appropriate state: KV caches for dense/MoE/VLM, O(1) recurrent
state for the SSM, hybrid state (mamba2 + shared-attention KV) for
zamba2, and encoder output + decoder KV for whisper.  Runs on the card
unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_decode
      [--arch falcon-mamba-7b] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data.batches import make_batch
from repro_torch.device import resolve_device
from repro_torch.models.model import init_cache, init_model
from repro_torch.train.steps import make_prefill_decode_step, make_serve_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS, default="smollm-135m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="torch device to decode on (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = init_model(cfg, gen)
    rng = np.random.default_rng(0)
    B, P = args.batch, args.prompt_len
    batch = make_batch(cfg, B, P, rng, device=dev)
    max_seq = P + args.new_tokens + 1
    cache = init_cache(cfg, B, max_seq=max_seq, device=dev)

    # fused prefill: the whole prompt in one forward (chunked attention
    # for kv-cache families, the chunked scan for recurrent state)
    serve = make_serve_step(cfg)
    prefill = make_prefill_decode_step(cfg)
    if cfg.family == "encdec":
        with torch.no_grad():
            cache["enc_out"] = model.encode(batch["frames"])
    t0 = time.time()
    logits, cache = prefill(model, cache, batch["tokens"])
    _sync(dev)
    t_prefill = time.time() - t0

    tok = logits.argmax(dim=-1, keepdim=True).to(torch.int32)
    out = [tok[:, 0].cpu().numpy()]
    t0 = time.time()
    for _ in range(args.new_tokens):
        logits, cache = serve(model, cache, tok)
        tok = logits.argmax(dim=-1, keepdim=True).to(torch.int32)
        out.append(tok[:, 0].cpu().numpy())
    dt = time.time() - t0

    gen_ids = np.stack(out, axis=1)
    print(f"{cfg.arch_id} ({cfg.family}): served {B} requests, "
          f"prefill {P} toks in {t_prefill:.2f}s, "
          f"decoded {args.new_tokens} toks in {dt:.2f}s "
          f"({B*args.new_tokens/max(dt, 1e-9):.1f} tok/s, smoke config "
          f"on {dev.type})")
    print("generated token ids (req 0):", gen_ids[0].tolist())
    state_keys = {k: tuple(v.shape) for k, v in cache.items()
                  if hasattr(v, "shape") and k != "len"}
    print("decode state:", state_keys)
    return gen_ids


if __name__ == "__main__":
    main()
