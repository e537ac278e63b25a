"""The segmented scatter (the managed lookup's backward in one kernel) and
the wrappers' shared launch checks, on the CPU.

On CPU tensors `segment_scatter_rows` runs its plain version: the step's
segment sum (`ref.segment_sum`) with pads outside the buffer, then the row
scatter.  It is held against the JAX package's
``ops.segment_rows(..., pad_id=V)`` followed by ``ops.scatter_rows(
use_pallas=False)``: the same rows written, rows of ids that occur once
bit for bit, summed rows within rtol 1e-6 (XLA's scatter-add may add a
run in another order; the tolerance `test_segment_and_unique_rows_match_
jax` states).  The CUDA kernel is held against this plain version on the
card in tests/test_torch_cuda.py, bit for bit, which needs the plain
version to add each run in sorted order: `test_plain_version_adds_each_
run_in_sorted_order` pins that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.pm_forward import step_residual as jstep_residual
from repro.pm.collectives import EmulatedBackend as JBackend
from repro.pm.embedding import pm_lookup as jpm_lookup
from repro_torch.kernels import adagrad_rows, embed_gather, ops, pm_forward
from repro_torch.kernels import scatter_rows as scatter_mod
from repro_torch.kernels import selective_scan as scan_mod
from repro_torch.kernels.build import CSRC, LAUNCHERS
from repro_torch.kernels.launch import (block_format, check_rows,
                                        index_operand)
from repro_torch.kernels.pm_forward import step_residual
from repro_torch.kernels.ref import segment_scatter_rows_ref
from repro_torch.kernels.scatter_rows import (check_segment_operands,
                                              segment_scatter_rows)
from repro_torch.pm.collectives import EmulatedBackend
from repro_torch.pm.embedding import make_state, pm_lookup

V, D = 512, 24
CPU = torch.device("cpu")


def t(a):
    return torch.from_numpy(np.array(a))


def tokens(case: str, T: int = 96, seed: int = 0) -> np.ndarray:
    """Zipf duplicates with row 0 and row V - 1 among them, or one run of
    a single id over all T tokens."""
    if case == "one_run":
        return np.full(T, 7, np.int32)
    rng = np.random.default_rng(seed)
    tok = (rng.zipf(1.3, size=T) % V).astype(np.int32)
    tok[:4] = [0, V - 1, 0, 5]
    return tok


def words(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.element_size() == 2
                else x.view(torch.int32)).numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("case", ["dups", "one_run"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_segment_then_scatter(case, dtype):
    tok = tokens(case)
    T = tok.size
    g = np.random.default_rng(1).normal(size=(T, D)).astype(np.float32)
    jg = jnp.asarray(g).astype(getattr(jnp, dtype))
    sid, sg = jops.segment_rows(jnp.asarray(tok), jg, n_slots=T, pad_id=V)
    want = np.asarray(jops.scatter_rows(
        jnp.zeros((V + 1, D), getattr(jnp, dtype)), sid, sg,
        use_pallas=False))
    tg = t(g).to(getattr(torch, dtype))
    base = torch.zeros((V + 1, D), dtype=getattr(torch, dtype))
    res = ops.sorted_slots(t(tok), T)
    for got in (segment_scatter_rows(base.clone(), res, tg),
                ops.segment_scatter_rows(base.clone(), res, tg),
                ops.segment_scatter_rows(base.clone(), res, tg,
                                         use_kernel=False)):
        assert got.dtype == base.dtype and got.shape == (V + 1, D)
        got_w, want_w = words(got), words(want)
        written = np.flatnonzero((got_w != 0).any(1))
        np.testing.assert_array_equal(
            written, np.flatnonzero((want_w != 0).any(1)))
        ids, counts = np.unique(tok, return_counts=True)
        np.testing.assert_array_equal(written, ids)
        once = ids[counts == 1]
        np.testing.assert_array_equal(got_w[once], want_w[once])
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=1e-6)


def test_plain_version_adds_each_run_in_sorted_order():
    """Each run is the fp32 sum taken left to right in sorted order,
    starting from 0.0 — the order the kernel adds in — bit for bit.
    Magnitudes over twelve decades make any other order show."""
    rng = np.random.default_rng(2)
    tok = tokens("dups", T=256, seed=3)
    g = (rng.normal(size=(tok.size, D))
         * 10.0 ** rng.uniform(-6, 6, size=(tok.size, 1))).astype(np.float32)
    res = ops.sorted_slots(t(tok), tok.size)
    got = segment_scatter_rows_ref(torch.zeros((V + 1, D)), res, t(g))
    want = np.zeros((V + 1, D), np.float32)
    written = np.zeros(V + 1, bool)
    order, s_ids = res.order.numpy(), res.sorted_ids.numpy()
    for k in range(tok.size):
        i = s_ids[k]
        if not written[i]:
            want[i] = np.float32(0.0)
            written[i] = True
        want[i] = (want[i] + g[order[k]]).astype(np.float32)
    np.testing.assert_array_equal(words(got), want.view(np.int32))


def test_step_residual_and_sorted_slots_give_the_same_rows():
    """The lookup passes the forward's `step_residual` sort; a caller
    without one sorts once (`ops.sorted_slots`): the same bits."""
    tok = tokens("dups", seed=4)
    cache = np.full(16, V, np.int32)
    cache[:5] = np.unique(tok)[:5]
    g = t(np.random.default_rng(4).normal(size=(tok.size, D))
          .astype(np.float32))
    a = segment_scatter_rows(torch.zeros((V + 1, D)),
                             step_residual(t(cache), t(tok), 32).sort, g)
    b = segment_scatter_rows(torch.zeros((V + 1, D)),
                             ops.sorted_slots(t(tok), tok.size), g)
    assert torch.equal(a, b)


def test_ids_outside_the_buffer_write_nothing():
    """Ids outside [0, R) are skipped and every row no id names keeps its
    bits (the base need not be zero)."""
    tok = t(np.array([3, -1, 3, 9, 12, 12, 40], np.int32))
    R = 12                                       # 12 and 40 fall outside
    base = torch.full((R, 4), 5.0)
    g = torch.ones((7, 4))
    got = segment_scatter_rows(base.clone(), ops.sorted_slots(tok, 7), g)
    want = base.clone()
    want[3], want[9] = 2.0, 1.0
    assert torch.equal(got, want)


@pytest.mark.parametrize("with_residual", [False, True])
def test_scatter_row_grads_kernel_entry_matches_jax(with_residual):
    """`EmulatedBackend.scatter_row_grads(kernel=True)` goes through the
    segmented entry, with the step's residual or sorting once itself."""
    tok = tokens("dups", seed=6)
    g = np.random.default_rng(6).normal(size=(tok.size, D)) \
        .astype(np.float32)
    want = JBackend().scatter_row_grads(jnp.asarray(tok), jnp.asarray(g), V,
                                        kernel=False)
    res = step_residual(t(np.full(8, V, np.int32)), t(tok), 16).sort \
        if with_residual else None
    ops.reset_launch_counts()
    got = EmulatedBackend().scatter_row_grads(t(tok), t(g), V, kernel=True,
                                              residual=res)
    assert got.shape == (V, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    assert set(ops.launch_counts().values()) == {0}   # CPU: plain version


@pytest.mark.parametrize("M", [64, 4])
def test_pm_lookup_backward_with_the_step_residual_matches_jax(M):
    """The train step hands the lookup its precomputed residual; the
    backward's one segmented write then gives JAX's table gradient within
    rtol 1e-6, overflowing misses (M = 4) included."""
    rng = np.random.default_rng(9)
    table = rng.normal(size=(V, D)).astype(np.float32)
    tok = tokens("dups", T=48, seed=9)
    cache = np.full(16, V, np.int32)
    cached = np.unique(tok)[::3][:16]
    cache[:cached.size] = cached
    tokens_2d = tok.reshape(4, 12)
    w = rng.normal(size=(4, 12, D)).astype(np.float32)
    jcr = JBackend().refresh_rows(jnp.asarray(table), jnp.asarray(cache))
    jres = jstep_residual(jnp.asarray(cache), jnp.asarray(tok), M)

    def jloss(tab):
        out = jpm_lookup(tab, jnp.asarray(cache), jcr,
                         jnp.asarray(tokens_2d), M, False, False, None,
                         jres)
        return jnp.sum(out * w)

    jg = jax.grad(jloss)(jnp.asarray(table))
    tab = t(table).requires_grad_(True)
    cr = make_state(tab.detach(), t(cache)).cache_rows
    res = step_residual(t(cache), t(tok), M)
    out = pm_lookup(tab, t(cache), cr, t(tokens_2d), M, kernel=True,
                    residual=res)
    (out * t(w)).sum().backward()
    np.testing.assert_allclose(tab.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)


def test_launch_checks_reject_what_the_kernels_do_not_take():
    """The shared launch path's checks, on CPU tensors: wrong device,
    dtype, rank, width, length or layout raise before any launch."""
    rows = torch.zeros((8, 4))
    with pytest.raises(ValueError, match="dtype"):
        check_rows("k", CPU, torch.zeros((8, 4), dtype=torch.int8))
    with pytest.raises(ValueError, match="contiguous"):
        check_rows("k", CPU, rows.t())
    with pytest.raises(ValueError, match="2-D"):
        check_rows("k", CPU, torch.zeros(8))
    with pytest.raises(ValueError, match="operands on"):
        check_rows("k", CPU, rows, torch.zeros((8, 4), device="meta"))
    with pytest.raises(ValueError, match="dtype or width"):
        check_rows("k", CPU, rows, torch.zeros((8, 5)))
    with pytest.raises(ValueError, match="1-D on"):
        index_operand("k", CPU, torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="1-D on"):
        index_operand("k", CPU, torch.zeros(2, dtype=torch.int32,
                                            device="meta"))
    ids = torch.arange(4, dtype=torch.int32)
    res = ops.sorted_slots(ids, 4)
    for base, grads, match in (
            (rows, torch.zeros((4, 5)), "width"),
            (rows, torch.zeros((3, 4)), "lengths"),
            (rows.to(torch.int32), torch.zeros((4, 4)), "dtype"),
            (rows, torch.zeros((4, 4), dtype=torch.float16), "dtype"),
            (rows, torch.zeros((4, 8))[:, ::2], "contiguous"),
            (rows, torch.zeros((4, 4), device="meta"), "operands on")):
        with pytest.raises(ValueError, match=match):
            check_segment_operands(CPU, base, res.order, res.sorted_ids,
                                   grads)
    with pytest.raises(ValueError, match="1-D on"):
        check_segment_operands(CPU, rows, res.order.to("meta"),
                               res.sorted_ids, torch.zeros((4, 4)))


def test_index_operand_passes_int32_through_and_casts_the_rest():
    x = torch.arange(6, dtype=torch.int32)
    assert index_operand("k", CPU, x) is x
    for y in (torch.arange(6), x[::2]):
        z = index_operand("k", CPU, y)
        assert z.dtype == torch.int32 and z.is_contiguous()
        assert torch.equal(z.long(), y.long())
    order, sorted_ids = check_segment_operands(
        CPU, torch.zeros((6, 2)), x.long(), x, torch.zeros((6, 2)))
    assert order.dtype == torch.int32 and sorted_ids is x


def described_blocks() -> dict:
    """Each launcher's argument block as the CUDA sources declare it
    (``#define <NAME>_ARGS(X) X(type, name, kind) ...`` then
    ``LAUNCH_ARGS(Struct, <NAME>_ARGS, <launcher>_args)``), written as the
    library describes it: "name:kind ..."."""
    import re
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        text = src.read_text().replace("\\\n", " ")
        macros = {m.group(1): m.group(2) for m in re.finditer(
            r"#define (\w+_ARGS)\(X\)(.*)", text)}
        for m in re.finditer(r"LAUNCH_ARGS\(\w+,\s*(\w+),\s*(\w+)_args\)",
                             text):
            fields = re.findall(r"X\([^,]+,\s*(\w+),\s*(\w)\)",
                                macros[m.group(1)])
            out[m.group(2)] = " ".join(f"{n}:{k}" for n, k in fields)
    return out


def test_every_wrapper_packs_the_block_its_launcher_declares():
    """Each wrapper's field list against the CUDA source's declaration of
    its launcher's argument block (the check `launcher` makes against the
    library at the first launch on a card), so a field added, dropped or
    reordered on one side fails here on the CPU."""
    blocks = described_blocks()
    wrappers = (embed_gather._launch, pm_forward._launch,
                adagrad_rows._launch, scatter_mod._scatter,
                scatter_mod._segment, scan_mod._fwd, scan_mod._bwd)
    assert sorted(blocks) == sorted(LAUNCHERS)
    assert sorted(w.cname for w in wrappers) == sorted(LAUNCHERS)
    for w in wrappers:
        fmt = block_format(w.cname, blocks[w.cname], w.fields)
        assert set(fmt[1:]) <= set("Qqd") and len(fmt) == len(w.fields) + 1
    assert block_format("adagrad_rows_launch",
                        blocks["adagrad_rows_launch"],
                        adagrad_rows._launch.fields) == "<QQQQqqqddq"


def test_block_format_rejects_a_block_the_wrapper_does_not_pack():
    assert block_format("k", "a:p b:i c:d ", ("a", "b", "c")) == "<Qqd"
    for described, fields in (("a:p b:i", ("b", "a")),
                              ("a:p b:i", ("a",)),
                              ("a:p b:x", ("a", "b"))):
        with pytest.raises(RuntimeError, match="argument block"):
            block_format("k", described, fields)
