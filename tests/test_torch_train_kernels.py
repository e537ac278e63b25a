"""The training slice's index stage, row kernels and managed lookup against
the JAX package's plain paths, on the same numpy inputs.

On the CPU the port's kernel wrappers run their plain versions.  They are
held against `repro.kernels.ref`, `repro.kernels.ops(use_pallas=False)`
and `repro.pm.collectives.EmulatedBackend(...kernel=False)`: index outputs
exactly, row scatters bit for bit, AdaGrad within rtol 1e-6 (XLA may fuse
``acc + g * g`` into one FMA; the port rounds the product first, as its
CUDA kernel does).  The CUDA kernels are held against the plain versions
on the card in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.pm_forward import step_residual as jstep_residual
from repro.pm.collectives import EmulatedBackend as JBackend
from repro.pm.embedding import pm_lookup as jpm_lookup
from repro_torch.kernels import ops, ref
from repro_torch.kernels.adagrad_rows import adagrad_row_update
from repro_torch.kernels.pm_forward import probe_and_compact, step_residual
from repro_torch.kernels.scatter_rows import scatter_rows
from repro_torch.pm.collectives import EmulatedBackend
from repro_torch.pm.embedding import (make_state, plain_lookup, pm_lookup,
                                      refresh_cache)

V, D = 512, 24


def t(a):
    return torch.from_numpy(np.array(a))


def tokens_and_cache(seed: int, T: int = 96, C: int = 24):
    """Zipf-ish tokens with duplicates, row 0 and row V-1 among them, and a
    sorted V-padded cache holding some of them."""
    rng = np.random.default_rng(seed)
    tok = (rng.zipf(1.3, size=T) % V).astype(np.int32)
    tok[:3] = [0, 0, V - 1]
    cached = np.unique(rng.choice(np.unique(tok), size=C // 2,
                                  replace=False))
    cache = np.full(C, V, np.int32)
    cache[:cached.size] = cached
    return tok, cache


@pytest.mark.parametrize("seed,M", [(0, 64), (1, 8), (2, 96), (3, 1)])
def test_step_residual_matches_jax_exactly(seed, M):
    tok, cache = tokens_and_cache(seed)
    want = jstep_residual(jnp.asarray(cache), jnp.asarray(tok), M)
    got = step_residual(t(cache), t(tok), M)
    for name in ("hit", "cache_slot", "buf_ids", "buf_slot", "n_miss",
                 "overflow"):
        np.testing.assert_array_equal(getattr(got.probe, name).numpy(),
                                      np.asarray(getattr(want.probe, name)),
                                      err_msg=name)
    for name in ("order", "sorted_ids", "slot"):   # stable sort: equal order
        np.testing.assert_array_equal(getattr(got.sort, name).numpy(),
                                      np.asarray(getattr(want.sort, name)),
                                      err_msg=name)
    assert int(got.n_uniq) == int(want.n_uniq)
    pc = probe_and_compact(t(cache), t(tok), M)
    assert torch.equal(pc.buf_ids, got.probe.buf_ids)


@pytest.mark.parametrize("use_residual", [False, True])
def test_segment_and_unique_rows_match_jax(use_residual):
    tok, cache = tokens_and_cache(4)
    T = tok.shape[0]
    g = np.random.default_rng(5).normal(size=(T, D)).astype(np.float32)
    jres = jstep_residual(jnp.asarray(cache), jnp.asarray(tok), 64).sort \
        if use_residual else None
    tres = step_residual(t(cache), t(tok), 64).sort if use_residual else None
    for n_slots in (T, 40):
        want = jops.sorted_slots(jnp.asarray(tok), n_slots, jres)
        got = ops.sorted_slots(t(tok), n_slots, tres)
        for w, h in zip(want, got):
            np.testing.assert_array_equal(h.numpy(), np.asarray(w))
    wid, wg = jops.segment_rows(jnp.asarray(tok), jnp.asarray(g), n_slots=T,
                                pad_id=V, residual=jres)
    gid, gg = ops.segment_rows(t(tok), t(g), n_slots=T, pad_id=V,
                               residual=tres)
    np.testing.assert_array_equal(gid.numpy(), np.asarray(wid))
    np.testing.assert_allclose(gg.numpy(), np.asarray(wg), rtol=1e-6)
    assert gg.dtype == torch.float32
    wu = jops.unique_rows(jnp.asarray(tok), n_slots=T, pad_id=V,
                          residual=jres)
    np.testing.assert_array_equal(
        ops.unique_rows(t(tok), n_slots=T, pad_id=V, residual=tres).numpy(),
        np.asarray(wu))


def adagrad_case(seed: int, dtype: str):
    """Table, warm accumulator, segment slots with row 0, duplicates
    pre-summed and V pads (the reference's
    ``test_sparse_rows_pad_cannot_cancel_row0`` layout)."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, D)).astype(np.float32)
    accum = rng.uniform(0.0, 0.5, size=(V, D)).astype(np.float32)
    tok = np.array([0, 5, 0, 9, 9, 9, 130, V - 1], np.int32)
    g = rng.normal(size=(tok.size, D)).astype(np.float32)
    jt = jnp.asarray(table).astype(getattr(jnp, dtype))
    tt = torch.from_numpy(table).to(getattr(torch, dtype))
    return tok, g, (jt, jnp.asarray(accum)), (tt, torch.from_numpy(accum))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_rows_matches_jax_with_row0_and_pads(dtype):
    tok, g, (jt, ja), (tt, ta) = adagrad_case(0, dtype)
    n = tok.size
    sid, sg = jops.segment_rows(jnp.asarray(tok), jnp.asarray(g), n_slots=n,
                                pad_id=V)
    assert int(sid[0]) == 0 and int(sid[-1]) == V      # row 0 and pads
    want_t, want_a = JBackend().update_rows(jt, ja, sid, sg, lr=0.05,
                                            kernel=False)
    seg_ids, seg_g = ops.segment_rows(t(tok), t(g), n_slots=n, pad_id=V)
    for kernel in (False, True):
        got_t, got_a = EmulatedBackend().update_rows(
            tt.clone(), ta.clone(), seg_ids, seg_g, lr=0.05, kernel=kernel)
        np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a),
                                   rtol=1e-6)
        np.testing.assert_allclose(got_t.float().numpy(),
                                   np.asarray(want_t.astype(jnp.float32)),
                                   rtol=1e-6, atol=1e-6 if dtype ==
                                   "float32" else 1e-2)
    # row 0 really moved, and untouched rows did not
    assert not torch.equal(got_t[0], tt[0])
    assert torch.equal(got_t[1], tt[1]) and torch.equal(got_a[1], ta[1])


def test_adagrad_row_update_matches_jax_ref():
    """On unique in-range ids the plain version is the reference's
    set-form oracle; pads outside [0, V) are skipped, not aliased."""
    tok, g, (jt, ja), (tt, ta) = adagrad_case(1, "float32")
    ids = np.unique(tok)
    gi = g[:ids.size]
    want_t, want_a = jref.adagrad_row_update_ref(jt, ja, jnp.asarray(ids),
                                                 jnp.asarray(gi), lr=0.1)
    got_t, got_a = adagrad_row_update(tt, ta, t(ids), t(gi), lr=0.1)
    assert got_t is tt and got_a is ta                   # in place
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=1e-6)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-6)
    before = (tt.clone(), ta.clone())
    pads = torch.tensor([V, V + 3, -1], dtype=torch.int32)
    for fn in (adagrad_row_update, ref.adagrad_row_update_ref):
        fn(tt, ta, pads, torch.ones(3, D), lr=0.1)
    assert torch.equal(tt, before[0]) and torch.equal(ta, before[1])


def test_adagrad_row_add_ref_matches_jax():
    tok, g, (jt, ja), (tt, ta) = adagrad_case(2, "float32")
    ids = np.array([3, 0, 0, 7], np.int32)
    gi = g[:4].copy()
    gi[2] = 0.0                                 # zero-grad duplicate of 0
    want_t, want_a = jref.adagrad_row_add_ref(jt, ja, jnp.asarray(ids),
                                              jnp.asarray(gi), lr=0.1)
    got_t, got_a = ref.adagrad_row_add_ref(tt, ta, t(ids), t(gi), lr=0.1)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=1e-6)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_rows_matches_jax_bitwise(dtype):
    """Unique ids plus pads colliding on the trash row V with zero rows."""
    rng = np.random.default_rng(3)
    ids = np.array([4, 0, V - 1, 77, V, V, V], np.int32)
    rows = rng.normal(size=(ids.size, D)).astype(np.float32)
    rows[ids == V] = 0.0
    jb = jnp.zeros((V + 1, D), getattr(jnp, dtype))
    tb = torch.zeros((V + 1, D), dtype=getattr(torch, dtype))
    want = jref.scatter_rows_ref(jb, jnp.asarray(ids), jnp.asarray(rows))
    for got in (scatter_rows(tb.clone(), t(ids), t(rows)),
                ops.scatter_rows(tb.clone(), t(ids), t(rows)),
                ops.scatter_rows(tb.clone(), t(ids), t(rows),
                                 use_kernel=False)):
        assert got.dtype == tb.dtype
        np.testing.assert_array_equal(
            got.view(torch.int16 if dtype == "bfloat16" else torch.int32)
            .numpy(),
            np.asarray(want).view(np.int16 if dtype == "bfloat16"
                                  else np.int32))


@pytest.mark.parametrize("kernel", [False, True])
def test_scatter_row_grads_matches_jax(kernel):
    tok, _ = tokens_and_cache(6)
    g = np.random.default_rng(6).normal(size=(tok.size, D)) \
        .astype(np.float32)
    want = JBackend().scatter_row_grads(jnp.asarray(tok), jnp.asarray(g), V,
                                        kernel=False)
    got = EmulatedBackend().scatter_row_grads(t(tok), t(g), V, kernel=kernel)
    assert got.shape == (V, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_refresh_paths_match_jax():
    rng = np.random.default_rng(7)
    table = rng.normal(size=(V, D)).astype(np.float32)
    _, cache = tokens_and_cache(7)
    C = cache.size
    st = make_state(t(table), t(cache))
    np.testing.assert_array_equal(st.cache_rows.numpy()[cache < V],
                                  table[cache[cache < V]])
    assert torch.equal(refresh_cache(st).cache_rows, st.cache_rows)
    # delta refresh after an update of some cached rows
    table2 = table.copy()
    hot = cache[[0, 2, 3]]
    table2[hot] += 1.0
    ids = np.full(8, V, np.int32)
    ids[:3] = hot
    slots = np.full(8, C, np.int32)
    slots[:3] = [0, 2, 3]
    want = JBackend().refresh_rows_delta(
        jnp.asarray(table2), jnp.asarray(st.cache_rows.numpy()),
        jnp.asarray(ids), jnp.asarray(slots))
    got = EmulatedBackend().refresh_rows_delta(
        t(table2), st.cache_rows.clone(), t(ids), t(slots))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[cache < V],
                                  table2[cache[cache < V]])


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("M", [64, 4])       # 4: unique misses overflow
def test_pm_lookup_matches_jax(kernel, M):
    """Forward bit for bit; table gradient within rtol 1e-6 (duplicate
    token gradients are summed in another order on the segmented path)."""
    rng = np.random.default_rng(8)
    table = rng.normal(size=(V, D)).astype(np.float32)
    tok, cache = tokens_and_cache(8, T=48)
    tokens = tok.reshape(4, 12)
    w = rng.normal(size=(4, 12, D)).astype(np.float32)
    jcr = JBackend().refresh_rows(jnp.asarray(table), jnp.asarray(cache))

    def jloss(tab):
        out = jpm_lookup(tab, jnp.asarray(cache), jcr, jnp.asarray(tokens),
                         M, False, False, None)
        return jnp.sum(out * w), out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(table))
    tab = t(table).requires_grad_(True)
    cr = make_state(tab.detach(), t(cache)).cache_rows
    n_miss = np.setdiff1d(tok, cache).size
    for host_count in (None, n_miss):
        tab.grad = None
        out = pm_lookup(tab, t(cache), cr, t(tokens), M, kernel=kernel,
                        n_miss=host_count)
        (out * t(w)).sum().backward()
        np.testing.assert_array_equal(out.detach().numpy(),
                                      np.asarray(jout))
        np.testing.assert_allclose(tab.grad.numpy(), np.asarray(jg),
                                   rtol=1e-6, atol=1e-6)
    # managed == plain, forward and backward, within the port
    tab2 = t(table).requires_grad_(True)
    plain = plain_lookup(tab2, t(tokens))
    (plain * t(w)).sum().backward()
    assert torch.equal(plain.detach(), out.detach())
    np.testing.assert_allclose(tab.grad.numpy(), tab2.grad.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_launch_counts_cover_every_kernel():
    assert set(ops.launch_counts()) == {"embed_gather", "pm_combine",
                                        "adagrad_rows", "scatter_rows",
                                        "segment_scatter_rows"}
    ops.reset_launch_counts()
    adagrad_row_update(torch.zeros(4, 2), torch.zeros(4, 2),
                       torch.tensor([1]), torch.ones(1, 2))
    scatter_rows(torch.zeros(4, 2), torch.tensor([1]), torch.ones(1, 2))
    # on CPU tensors the wrappers run the plain versions: no launch
    assert set(ops.launch_counts().values()) == {0}
