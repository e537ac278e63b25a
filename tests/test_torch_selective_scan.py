"""The Mamba-1 selective scan on the CPU: the plain reverse pass that the
CUDA backward follows (`kernels/ref.py::selective_scan_backward_ref`)
against autograd through the plain forward, in float64; `mamba1_block`
on CPU tensors taking the plain version with no launch; and the
wrapper's operand checks.  The kernels themselves run only on a card
(`tests/test_torch_cuda.py`)."""

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import selective_scan as scan_mod
from repro_torch.kernels.ref import (selective_scan_backward_ref,
                                     selective_scan_ref)
from repro_torch.models import ssm


def scan_operands(B, S, di, N, dtype, seed: int = 0):
    """Seeded operands of the scan's range: delta in (0, 0.5), A < 0."""
    g = torch.Generator().manual_seed(seed)
    u = torch.randn((B, S, di), generator=g, dtype=dtype)
    delta = torch.rand((B, S, di), generator=g, dtype=dtype) * 0.5
    A = -torch.rand((di, N), generator=g, dtype=dtype) * 3 - 0.1
    Bm, Cm = (torch.randn((B, S, N), generator=g, dtype=dtype)
              for _ in range(2))
    D = torch.randn((di,), generator=g, dtype=dtype)
    h0 = torch.randn((B, di, N), generator=g, dtype=dtype)
    return u, delta, A, Bm, Cm, D, h0


@pytest.mark.parametrize("with_h0", [False, True])
def test_backward_ref_equals_autograd_of_the_plain_scan(with_h0):
    """Every gradient of sum(y * w) + sum(h_last * w_last), from the
    position-by-position reverse pass and from autograd through
    `selective_scan_ref` (its doubling scan in chunks of 3 over 7
    positions), agree within 1e-10 in float64."""
    B, S, di, N = 2, 7, 5, 4
    *ops, h0 = scan_operands(B, S, di, N, torch.float64)
    g = torch.Generator().manual_seed(1)
    w = torch.randn((B, S, di), generator=g, dtype=torch.float64)
    w_last = torch.randn((B, di, N), generator=g, dtype=torch.float64)
    xs = [t.clone().requires_grad_(True)
          for t in ops + ([h0] if with_h0 else [])]
    y, h_last = selective_scan_ref(*xs[:6], xs[6] if with_h0 else None,
                                   chunk=3)
    ((y * w).sum() + (h_last * w_last).sum()).backward()
    got = selective_scan_backward_ref(*ops, h0 if with_h0 else None, w,
                                      w_last)
    for x, want in zip(xs, got):
        np.testing.assert_allclose(x.grad.numpy(), want.numpy(), rtol=1e-10,
                                   atol=1e-10)
    assert got[-1].shape == (B, di, N)


def test_mamba1_block_on_the_cpu_takes_the_plain_path(monkeypatch):
    """Training (no state) and the fused prefill (a state, S > 1) call the
    plain version on CPU tensors, and no kernel launch is counted."""
    cfg = get_config("falcon-mamba-7b", smoke=True)
    p = ssm.init_mamba1(torch.Generator().manual_seed(0), cfg.d_model,
                        cfg.d_inner, cfg.ssm_state, cfg.ssm_conv,
                        cfg.dt_rank, torch.float32)
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    calls = []

    def plain(*args, **kwargs):
        calls.append(args[6] is not None)
        return selective_scan_ref(*args, **kwargs)

    monkeypatch.setattr(scan_mod, "selective_scan_ref", plain)
    ops.reset_launch_counts()
    kw = dict(ssm_state=cfg.ssm_state, dt_rank=cfg.dt_rank)
    x = torch.randn((2, 5, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    out, state = ssm.mamba1_block(x, p, **kw)
    out.sum().backward()
    assert state is None and p["A_log"].grad is not None
    state = (torch.zeros((2, cfg.ssm_conv - 1, cfg.d_inner)),
             torch.zeros((2, cfg.d_inner, cfg.ssm_state)))
    with torch.no_grad():
        ssm.mamba1_block(x, p, state=state, **kw)
        ssm.mamba1_block(x[:, :1], p, state=state, **kw)   # a decode step
    assert calls == [False, True]
    assert set(ops.launch_counts().values()) == {0}


def test_the_wrapper_rejects_what_the_kernels_do_not_take():
    """fp32, N = 16, matching shapes: anything else raises before a
    launch (the check is the same on any device)."""
    good = scan_operands(2, 3, 4, 16, torch.float32)
    scan_mod._operands(*good)
    *ops, h0 = good
    for i, bad, match in (
            (2, ops[2][:, :8], "A must be"),
            (0, ops[0].double(), "u must be"),
            (3, ops[3][:, :2], "Bm must be"),
            (6, h0[:1], "h0 must be"),
            (0, ops[0][:, :0], "non-empty")):
        args = list(good)
        args[i] = bad
        with pytest.raises(ValueError, match=match):
            scan_mod._operands(*args)
