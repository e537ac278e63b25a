"""The port's blocked online-softmax attention (`layers.flash_attention`)
against the reference's, on the same numpy inputs, at small blocks (q
blocks of 4 against kv blocks of 8) so that several tiles, ragged last
blocks and skipped tiles occur: causal, sliding window, GQA,
cross-attention (Sq != Skv), a query offset and fully masked rows.
Outputs within rtol 1e-5 / atol 1e-6.  With M-RoPE angles
(`layers.rope_angles` with sections): each frequency band driven by its
section's coordinate exactly, cos and sin within one float32 ulp of the
reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.models import layers

QB, KB = 4, 8
# name -> (Sq, Skv, H, KvH, causal, window, q_offset)
CASES = {
    "causal": (21, 21, 4, 4, True, 0, 0),
    "causal_gqa": (21, 21, 4, 2, True, 0, 0),
    "window": (23, 23, 4, 2, True, 5, 0),
    "window_not_causal": (17, 17, 2, 1, False, 6, 0),
    "cross": (7, 19, 4, 4, False, 0, 0),
    "cross_long_q": (30, 9, 4, 2, False, 0, 0),
    "q_offset": (5, 13, 4, 2, True, 0, 8),
    "fully_masked_rows": (11, 11, 2, 2, True, 0, -3),
}


def inputs(Sq, Skv, H, KvH, seed=0, hd=8, B=2):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, Skv, KvH, hd)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def both(case, q, k, v, **blocks):
    Sq, Skv, H, KvH, causal, window, off = CASES[case]
    kw = dict(causal=causal, window=window, q_offset=off, **blocks)
    want = jlayers.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), **kw)
    got = layers.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), **kw)
    return got, np.asarray(want)


@pytest.mark.parametrize("case", list(CASES))
def test_flash_attention_matches_jax(case):
    Sq, Skv, H, KvH = CASES[case][:4]
    q, k, v = inputs(Sq, Skv, H, KvH)
    got, want = both(case, q, k, v, q_block=QB, kv_block=KB)
    assert tuple(got.shape) == want.shape == (2, Sq, H, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    if case == "fully_masked_rows":
        # positions -3 .. -1 see no key: zeros, as the reference gives
        assert not want[:, :3].any() and not got[:, :3].any()


@pytest.mark.parametrize("case", ["causal", "cross"])
def test_flash_attention_default_blocks_match_jax(case):
    """The default 512 x 1024 blocks: one tile at these lengths."""
    Sq, Skv, H, KvH = CASES[case][:4]
    q, k, v = inputs(Sq, Skv, H, KvH, seed=1)
    got, want = both(case, q, k, v)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case,tiles", [("causal", 12), ("window", 8),
                                        ("fully_masked_rows", 3),
                                        ("cross", 6)])
def test_fully_masked_tiles_are_skipped(case, tiles, monkeypatch):
    """Causal: 6 q blocks x 3 kv blocks, of which 6 lie wholly above the
    diagonal; the window of 5 leaves 8 of 18 within reach; the query
    offset -3 leaves 3 of 6 with a visible key; cross-attention skips
    none of its 2 x 3."""
    calls = []
    real = layers._block_attn

    def counted(*a):
        calls.append(a[3] is None)
        return real(*a)

    monkeypatch.setattr(layers, "_block_attn", counted)
    Sq, Skv, H, KvH = CASES[case][:4]
    q, k, v = inputs(Sq, Skv, H, KvH)
    got, want = both(case, q, k, v, q_block=QB, kv_block=KB)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert len(calls) == tiles
    if case == "cross":
        assert all(calls)              # no tile builds a mask
    if case == "causal":
        assert any(calls) and not all(calls)


@pytest.mark.parametrize("case", ["causal_gqa", "window", "cross"])
def test_flash_attention_gradients_match_jax(case):
    """Gradients with respect to q, k and v of a weighted sum of the
    output: ``jax.grad`` of the reference's scan against autograd of the
    port's tiles (whose running max carries no gradient)."""
    Sq, Skv, H, KvH, causal, window, off = CASES[case]
    q, k, v = inputs(Sq, Skv, H, KvH, seed=2)
    w = np.random.default_rng(3).normal(size=(2, Sq, H, 8)) \
        .astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=off, q_block=QB,
              kv_block=KB)

    def jloss(q, k, v):
        return jnp.sum(jlayers.flash_attention(q, k, v, **kw) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    (layers.flash_attention(*ts, **kw) * torch.from_numpy(w)).sum() \
        .backward()
    for t, g in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [0, 6])
def test_flash_attention_equals_decode_attention(window):
    """Causal attention over S positions equals `decode_attention` with
    ``cache_len = S`` (plain softmax over the whole prefix)."""
    q, k, v = inputs(37, 37, 4, 2, seed=4)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = layers.flash_attention(tq, tk, tv, causal=True, window=window,
                                 q_block=QB, kv_block=KB)
    want = layers.decode_attention(tq, tk, tv, 37, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_mrope_angles_match_jax():
    """M-RoPE at the smoke config's sections and the published ones, with
    distinct t, h and w coordinates."""
    rng = np.random.default_rng(5)
    for head_dim, sections in ((32, (8, 4, 4)), (128, (16, 24, 24))):
        pos = rng.integers(0, 300, size=(2, 9, 3)).astype(np.int32)
        want = jlayers.rope_angles(jnp.asarray(pos), head_dim, 1e6,
                                   sections)
        got = layers.rope_angles(torch.from_numpy(pos), head_dim, 1e6,
                                 sections)
        # within one float32 ulp at 1: XLA's and PyTorch's cos and sin
        # differ in the last bit on some arguments
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=2.0 ** -23)
        # exactly: each band reads its section's coordinate
        plain = [layers.rope_angles(torch.from_numpy(pos[..., c]),
                                    head_dim, 1e6) for c in range(3)]
        edges = np.cumsum((0,) + sections)
        for c in range(3):
            sl = slice(edges[c], edges[c + 1])
            for g, p in zip(got, plain[c]):
                assert torch.equal(g[..., sl], p[..., sl])
    with pytest.raises(ValueError, match="do not cover"):
        layers.rope_angles(torch.zeros((1, 2, 3)), 32, 1e6, (8, 8, 8))
