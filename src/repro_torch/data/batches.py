"""Batch construction shared by the data pipeline and the tests (the twin
of `repro/data/batches.py`).  Random fields are drawn from the caller's
numpy generator in the reference's order, so a seed gives the same batch
in both packages."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def batch_struct(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, Any]:
    """Shape/dtype description of one training/prefill batch (numpy
    metadata)."""
    d: Dict[str, Any] = {
        "tokens": ((batch, seq), np.int32),
        "labels": ((batch, seq), np.int32),
    }
    if cfg.mrope:
        d["positions"] = ((batch, seq, 3), np.int32)
    else:
        d["positions"] = ((batch, seq), np.int32)
    if cfg.family == "vlm":
        n = min(cfg.n_img_tokens, max(1, seq // 4))
        d["img_embeds"] = ((batch, n, cfg.d_model), np.float32)
        d["img_pos"] = ((batch, n), np.int32)
    if cfg.family == "encdec":
        d["frames"] = ((batch, cfg.encoder.n_frames, cfg.d_model),
                       np.float32)
    return d


def make_batch(cfg: ModelConfig, batch: int, seq: int,
               rng: np.random.Generator, device=None
               ) -> Dict[str, torch.Tensor]:
    """A concrete random batch matching `batch_struct`, as tensors on
    ``device`` (None: the CPU)."""
    out: Dict[str, torch.Tensor] = {}
    for name, (shape, dtype) in batch_struct(cfg, batch, seq).items():
        if name == "tokens" or name == "labels":
            arr = rng.integers(0, cfg.vocab_size, size=shape)
        elif name == "positions":
            if cfg.mrope:
                arr = np.broadcast_to(
                    np.arange(seq)[None, :, None], shape).copy()
            else:
                arr = np.broadcast_to(np.arange(seq)[None, :], shape).copy()
        elif name == "img_pos":
            n = shape[1]
            arr = np.broadcast_to(np.arange(n)[None, :], shape).copy()
        else:
            arr = rng.normal(size=shape).astype(np.float32) * 0.02
        out[name] = torch.from_numpy(np.asarray(arr, dtype=dtype)).to(device)
    return out
