"""The Mamba-1 selective scan: the CUDA kernels' wrapper and autograd.

Replaces no TPU kernel: the reference's scan is plain `jnp`
(`repro/models/ssm.py::mamba1_block`), and so was the port's
(`ref.selective_scan_ref`, which CPU tensors still take).
Added because that composition set falcon-mamba-7b's training pace on the
card: it materialises (B, S, d_inner, N) fp32 tensors, 1.07 GB each at
(1, 2048, 8192, 16), and sweeps them many times.  The kernels
(``csrc/selective_scan.cu``) keep the states in registers and read and
write only the (B, S, d_inner) and (B, S, N) operands, so they are bound
by those bytes and by one ``expf`` per state and position; the file's
head says how the forward and the backward are laid out.

On CUDA tensors `selective_scan` launches the kernels (or raises); the
forward saves its operands and the state at the start of every 256
positions for the backward, which recomputes the states from them.
"""

from __future__ import annotations

import torch

from .launch import launcher
from .ref import selective_scan_ref

#: states a channel, positions between saved states, channels a block
#: (one partial of dB and dC each): ``kN``, ``kChunk`` and ``kChannels``
#: of the kernels
N_STATES, CHUNK, CHANNELS = 16, 256, 32

_fwd = launcher("selective_scan_fwd_launch",
                "u delta A Bm Cm D h0 y h_last hs batch S di n_chunks")
_bwd = launcher("selective_scan_bwd_launch",
                "u delta A Bm Cm D hs dy dh_last du ddelta dh0 dA_part "
                "dD_part dBC_part dA dD dBC batch S di n_chunks n_parts")


def selective_scan(u, delta, A, Bm, Cm, D, h0=None):
    """``h_t = exp(delta_t A) h_{t-1} + delta_t u_t B_t`` from ``h0``
    (zeros when None) and ``y_t = sum_n h_t C_t + D u_t``; returns ``(y,
    h_last)``, differentiable in every operand.

    u, delta (B, S, di); A (di, N); Bm, Cm (B, S, N); D (di,); h0 (B, di,
    N) or None.  On CUDA tensors (fp32, N = 16) this launches the
    kernels, or raises; on CPU tensors (the dry run's DTensors among
    them) it is the plain version.  Each call counts
    ``selective_scan.launches``, each backward
    ``selective_scan.backward_launches`` (`ops.launch_counts`)."""
    if not u.is_cuda:
        return selective_scan_ref(u, delta, A, Bm, Cm, D, h0)
    return SelectiveScan.apply(u, delta, A, Bm, Cm, D, h0)


selective_scan.launches = 0
selective_scan.backward_launches = 0


def _operands(u, delta, A, Bm, Cm, D, h0):
    """The operands contiguous; raises `ValueError` unless they are fp32
    on one card with the shapes `selective_scan` names and N = 16."""
    if u.dim() != 3 or 0 in u.shape:
        raise ValueError(f"selective_scan: u must be a non-empty (B, S, "
                         f"di) tensor, got {tuple(u.shape)}")
    B, S, di = u.shape
    want = {"u": (u, (B, S, di)), "delta": (delta, (B, S, di)),
            "A": (A, (di, N_STATES)), "Bm": (Bm, (B, S, N_STATES)),
            "Cm": (Cm, (B, S, N_STATES)), "D": (D, (di,))}
    if h0 is not None:
        want["h0"] = (h0, (B, di, N_STATES))
    for name, (t, shape) in want.items():
        if (t.device != u.device or t.dtype != torch.float32
                or tuple(t.shape) != shape):
            raise ValueError(f"selective_scan: {name} must be fp32 {shape} "
                             f"on {u.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return [None if t is None else t.contiguous()
            for t in (u, delta, A, Bm, Cm, D, h0)]


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


class SelectiveScan(torch.autograd.Function):
    """`selective_scan` on the card: the forward kernel saves the state at
    the start of every `CHUNK` positions, (B, di, ceil(S / CHUNK), N); the
    backward kernel recomputes the states from them and writes every
    gradient, dB and dC through per-block partials that a second pass
    adds in a fixed order (no atomics: the same bits in every run)."""

    @staticmethod
    def forward(ctx, u, delta, A, Bm, Cm, D, h0):
        u, delta, A, Bm, Cm, D, h0 = _operands(u, delta, A, Bm, Cm, D, h0)
        B, S, di = u.shape
        n_chunks = -(-S // CHUNK)
        y = torch.empty_like(u)
        h_last = u.new_empty((B, di, N_STATES))
        hs = u.new_empty((B, di, n_chunks, N_STATES))
        _fwd(u.get_device(), u.data_ptr(), delta.data_ptr(), A.data_ptr(),
             Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(), _ptr(h0),
             y.data_ptr(), h_last.data_ptr(), hs.data_ptr(), B, S, di,
             n_chunks)
        selective_scan.launches += 1
        ctx.save_for_backward(u, delta, A, Bm, Cm, D, hs)
        ctx.with_h0 = h0 is not None
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        u, delta, A, Bm, Cm, D, hs = ctx.saved_tensors
        B, S, di = u.shape
        n_parts = -(-di // CHANNELS)
        dy, dh_last = dy.contiguous(), dh_last.contiguous()
        du, ddelta = torch.empty_like(u), torch.empty_like(u)
        dh0 = u.new_empty((B, di, N_STATES)) if ctx.with_h0 else None
        dA_part = u.new_empty((B, di, N_STATES))
        dD_part = u.new_empty((B, di))
        dBC_part = u.new_empty((n_parts, B, S, 2 * N_STATES))
        dA, dD = torch.empty_like(A), torch.empty_like(D)
        dBC = u.new_empty((B, S, 2 * N_STATES))
        _bwd(u.get_device(), u.data_ptr(), delta.data_ptr(), A.data_ptr(),
             Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(), hs.data_ptr(),
             dy.data_ptr(), dh_last.data_ptr(), du.data_ptr(),
             ddelta.data_ptr(), _ptr(dh0), dA_part.data_ptr(),
             dD_part.data_ptr(), dBC_part.data_ptr(), dA.data_ptr(),
             dD.data_ptr(), dBC.data_ptr(), B, S, di, hs.shape[2], n_parts)
        selective_scan.backward_launches += 1
        return (du, ddelta, dA, dBC[..., :N_STATES], dBC[..., N_STATES:], dD,
                dh0)
