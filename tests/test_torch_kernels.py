"""The port's kernels against the JAX package's, on the same numpy inputs.

On the CPU the port's wrappers run their plain versions; they must equal
the JAX package's plain references (`repro.kernels.ops` with
``use_pallas=False``, the path its serving runtime takes with
``kernel=False``) bit for bit, in fp32 and in bf16 (cast from the same
fp32 array in both frameworks, compared as raw 16-bit words).  The CUDA
kernels themselves are held against the plain versions on the card in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops
from repro_torch.kernels.embed_gather import embed_gather
from repro_torch.kernels.pm_forward import pm_combine
from repro_torch.kernels.ref import embed_gather_ref

# tests/test_kernels.py::SHAPES (V, D, n) plus the odd widths 8 and 576
SHAPES = [(64, 128, 8), (1024, 256, 32), (512, 512, 64), (256, 384, 16),
          (300, 8, 40), (200, 576, 24)]
DTYPES = ["float32", "bfloat16"]


def both(a: np.ndarray, dtype: str):
    """The same fp32 numpy array as a JAX array and a torch tensor of
    ``dtype``."""
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def words(x) -> np.ndarray:
    """Raw words of a JAX array or torch tensor, for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.element_size() == 2 \
            else x.view(torch.int32)
        return x.numpy().view(np.uint16 if x.element_size() == 2
                              else np.uint32)
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("V,D,n", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_gather_matches_jax(V, D, n, dtype):
    rng = np.random.default_rng(0)
    jt, tt = both(rng.normal(size=(V, D)).astype(np.float32), dtype)
    ids = rng.integers(0, V, size=n).astype(np.int32)
    ids[0] = 0
    want = jops.embed_gather(jt, jnp.asarray(ids), use_pallas=False)
    tids = torch.from_numpy(ids)
    for got in (embed_gather(tt, tids), ops.embed_gather(tt, tids),
                ops.embed_gather(tt, tids, use_kernel=False)):
        assert got.dtype == tt.dtype and got.shape == (n, D)
        np.testing.assert_array_equal(words(got), words(want))


@pytest.mark.parametrize("V,D,n", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_pm_combine_matches_jax(V, D, n, dtype):
    rng = np.random.default_rng(1)
    T, C, M = 4 * n, V // 4, n // 2
    jc, tc = both(rng.normal(size=(C, D)).astype(np.float32), dtype)
    buf = rng.normal(size=(M + 1, D)).astype(np.float32)
    buf[M] = 0.0                               # the trash row
    jb, tb = both(buf, dtype)
    hit = rng.integers(0, 2, size=T).astype(np.int32)
    cslot = rng.integers(0, C, size=T).astype(np.int32)
    bslot = rng.integers(0, M + 1, size=T).astype(np.int32)
    want = jops.pm_combine(*(jnp.asarray(x) for x in (hit, cslot, bslot)),
                           jc, jb, use_pallas=False)
    targs = [torch.from_numpy(x) for x in (hit, cslot, bslot)]
    for got in (pm_combine(*targs, tc, tb), ops.pm_combine(*targs, tc, tb),
                ops.pm_combine(*targs, tc, tb, use_kernel=False)):
        assert got.dtype == tc.dtype and got.shape == (T, D)
        np.testing.assert_array_equal(words(got), words(want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_gather_zero_row_contract(dtype):
    """Ids outside [0, V) — the runtime's V pads — gather zero rows; the
    others gather their table rows.  (JAX's `jnp.take` fills such ids
    with NaN instead; no probe slot ever points at them.)"""
    rng = np.random.default_rng(2)
    V, D = 50, 12
    table = torch.from_numpy(
        rng.normal(size=(V, D)).astype(np.float32)).to(getattr(torch, dtype))
    ids = torch.tensor([0, V, 7, V + 5, -1, V - 1, V], dtype=torch.int32)
    for got in (embed_gather(table, ids), embed_gather_ref(table, ids)):
        pad = torch.tensor([False, True, False, True, True, False, True])
        assert torch.count_nonzero(got[pad]) == 0
        assert torch.equal(got[~pad], table[ids[~pad].long()])


def test_cpu_path_counts_no_launches():
    """The plain versions on CPU tensors are not kernel launches."""
    ops.reset_launch_counts()
    table = torch.zeros((8, 4))
    ops.embed_gather(table, torch.tensor([1, 2], dtype=torch.int32))
    ops.pm_combine(torch.ones(2, dtype=torch.int32),
                   torch.zeros(2, dtype=torch.int32),
                   torch.zeros(2, dtype=torch.int32), table, table)
    assert ops.launch_counts() == {"embed_gather": 0, "pm_combine": 0,
                                   "adagrad_rows": 0, "scatter_rows": 0,
                                   "segment_scatter_rows": 0,
                                   "selective_scan": 0,
                                   "selective_scan_backward": 0}


@pytest.mark.parametrize("n, n_unique", [(40, 40), (40, 64), (7, 7)])
def test_segment_rows_ref_matches_reference(n, n_unique):
    """`ref.segment_rows_ref` against `repro.kernels.ref.segment_rows_ref`
    on the same ids (duplicates, and unused slots padded with -1) and
    fp32 gradients: ids equal, sums bit for bit."""
    from repro.kernels.ref import segment_rows_ref as jsegment_rows_ref
    from repro_torch.kernels.ref import segment_rows_ref
    rng = np.random.default_rng(n)
    ids = rng.integers(0, 30, n).astype(np.int32)
    ids[: n // 3] = ids[n // 3: 2 * (n // 3)]
    g = rng.normal(size=(n, 12)).astype(np.float32)
    want_ids, want = jsegment_rows_ref(jnp.asarray(ids), jnp.asarray(g),
                                       n_unique)
    got_ids, got = segment_rows_ref(torch.from_numpy(ids),
                                    torch.from_numpy(g), n_unique)
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(words(got), words(want))
