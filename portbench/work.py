"""The work a step needs, reckoned from the configuration's shapes and
the step's tokens by the benchmark's own arithmetic, whatever implements
it: model FLOPs for utilisation, and the least bytes of the managed
lookup and the row update for the lookup kernels' roofline.  A family's
own counts (``matmul_params``, ``attention_flops``) sit in its reference
file, ``reference/<family>.py``, found by the configuration's
``reference``; this file only sums them."""

from __future__ import annotations

import numpy as np

from portbench.reference.steps import family


def model_flops(cfg: dict, B: int, S: int) -> float:
    """One training step's model FLOPs on B x S tokens: 6 x matmul
    parameters x tokens plus attention's products.  Recomputation
    (rematerialisation) is not counted."""
    f = family(cfg)
    return 6.0 * f.matmul_params(cfg) * B * S + f.attention_flops(cfg, B, S)


def lookup_bytes(cfg: dict, tokens: np.ndarray, update: bool) -> float:
    """The least bytes of the managed lookup for ``tokens``: read each
    unique row once and write each token's row, ``(U + T) x D x 4``;
    with ``update``, the row update's too: read the row, its accumulator
    and its gradient, write the row and the accumulator, ``5 x U x D x
    4``."""
    T = int(tokens.size)
    U = int(np.unique(tokens).size)
    row = cfg["d_model"] * 4
    return (U + T) * row + (5 * U * row if update else 0)
