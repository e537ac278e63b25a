"""The port on the card: each CUDA kernel against its plain version, bit
for bit, and the serving runtime and the training loop on CUDA against
themselves on the CPU.

Every test here needs a CUDA card and the CUDA toolkit; without a card
they skip.  This file imports no JAX, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.ckpt import checkpoint
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.adagrad_rows import adagrad_row_update
from repro_torch.kernels.embed_gather import embed_gather
from repro_torch.kernels.pm_forward import pm_combine
from repro_torch.kernels.ref import (adagrad_row_update_ref,
                                     embed_gather_ref, pm_combine_ref,
                                     scatter_rows_ref)
from repro_torch.kernels.scatter_rows import scatter_rows
from repro_torch.models.model import init_model
from repro_torch.train.loop import LoopConfig, checkpoint_tree, train_loop
from repro_torch.train.steps import make_opt_init
from repro_torch.serve import (DriftingZipfStream, ReplayStream, ServeConfig,
                               ServingRuntime)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def raw(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.uint8)


@pytest.mark.parametrize("D", [1, 3, 8, 576, 6144])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain(dev, D, dtype):
    g = torch.Generator(device=dev)
    g.manual_seed(D)
    V, n, C, M = 3000, 1024, 512, 64
    table = torch.randn((V, D), generator=g, device=dev).to(dtype)
    ids = torch.randint(0, V + 1, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    ids[0], ids[1] = 0, V - 1
    ops.reset_launch_counts()
    got = embed_gather(table, ids)
    torch.cuda.synchronize()
    assert torch.equal(raw(got), raw(embed_gather_ref(table, ids)))
    cache = torch.randn((C, D), generator=g, device=dev).to(dtype)
    buf = torch.randn((M + 1, D), generator=g, device=dev).to(dtype)
    buf[M] = 0
    hit = torch.randint(0, 2, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    cslot = torch.randint(0, C, (n,), generator=g, device=dev,
                          dtype=torch.int32)
    bslot = torch.randint(0, M + 1, (n,), generator=g, device=dev,
                          dtype=torch.int32)
    got = pm_combine(hit, cslot, bslot, cache, buf)
    torch.cuda.synchronize()
    want = pm_combine_ref(hit, cslot, bslot, cache, buf)
    assert torch.equal(raw(got), raw(want))
    assert ops.launch_counts() == {"embed_gather": 1, "pm_combine": 1,
                                   "adagrad_rows": 0, "scatter_rows": 0}


@pytest.mark.parametrize("D", [1, 3, 8, 576, 6144])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_training_kernels_match_plain(dev, D, dtype):
    """`adagrad_rows` and `scatter_rows` against their plain versions bit
    for bit, with row 0 and V pads among the ids."""
    g = torch.Generator(device=dev)
    g.manual_seed(100 + D)
    V, n = 3000, 512
    # unique ids (the kernel's contract): 1..V-2 drawn, then 0 and V-1
    ids = (torch.randperm(V - 2, generator=g, device=dev)[:n] + 1) \
        .to(torch.int32)
    ids[0], ids[1] = 0, V - 1
    ids[2::9] = V                                # pads: skipped
    table = torch.randn((V, D), generator=g, device=dev).to(dtype)
    accum = torch.rand((V, D), generator=g, device=dev)
    grads = torch.randn((n, D), generator=g, device=dev)
    ops.reset_launch_counts()
    t_k, a_k = adagrad_row_update(table.clone(), accum.clone(), ids, grads,
                                  lr=0.01)
    t_p, a_p = adagrad_row_update_ref(table.clone(), accum.clone(), ids,
                                      grads, lr=0.01)
    torch.cuda.synchronize()
    assert torch.equal(raw(t_k), raw(t_p)) and torch.equal(raw(a_k),
                                                           raw(a_p))
    assert not torch.equal(t_k[0], table[0])
    untouched = torch.ones(V, dtype=torch.bool, device=dev)
    untouched[ids[ids < V].long()] = False
    assert torch.equal(raw(t_k[untouched]), raw(table[untouched]))
    base = torch.zeros((V + 1, D), dtype=dtype, device=dev)
    rows = torch.randn((n, D), generator=g, device=dev)
    rows[ids == V] = 0
    got = scatter_rows(base.clone(), ids, rows)
    torch.cuda.synchronize()
    assert torch.equal(raw(got), raw(scatter_rows_ref(base.clone(), ids,
                                                      rows)))
    assert ops.launch_counts() == {"embed_gather": 0, "pm_combine": 0,
                                   "adagrad_rows": 1, "scatter_rows": 1}


@pytest.mark.parametrize("arch", ["nemotron-4-15b", "smollm-135m"])
def test_train_loop_on_the_card_equals_the_cpu(dev, arch, tmp_path):
    """The same start (a checkpoint with a warm accumulator) trained on
    CUDA through the kernels and on the CPU through the plain versions:
    the loss traces agree within rtol 1e-4 / atol 1e-5 (matmuls and
    `index_add_`'s atomics sum in other orders on the card), and the
    kernels of each arm ran."""
    cfg = get_config(arch, smoke=True)
    model = init_model(cfg, torch.Generator().manual_seed(0))
    state = make_opt_init()(model)
    g = torch.Generator().manual_seed(1)
    for a in state.accum.values():
        a.copy_(torch.rand(a.shape, generator=g) * 1e-4 + 5e-5)
    checkpoint.save(str(tmp_path), checkpoint_tree(model, state), 0)
    lc = LoopConfig(steps=24, batch=2, seq=16, refresh_every=2,
                    pipeline_depth=1, kernel=True, log_every=0,
                    init_from=str(tmp_path))
    want = train_loop(cfg, lc, device="cpu")
    ops.reset_launch_counts()
    got = train_loop(cfg, lc)
    counts = ops.launch_counts()
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4,
                               atol=1e-5)
    assert got.overflows == want.overflows == 0
    assert counts["embed_gather"] >= 24 and counts["pm_combine"] >= 24
    if cfg.tie_embeddings:       # dense arm: the lookup's backward scatter
        assert counts["scatter_rows"] >= 24 and counts["adagrad_rows"] == 0
    else:                        # fused arm: the sparse row update
        assert counts["adagrad_rows"] >= 24 and counts["scatter_rows"] == 0


def test_unaligned_views_and_int64_ids(dev):
    """A row slice whose base is not 16-byte aligned takes narrower words;
    int64 ids are cast, not rejected."""
    table = torch.arange(40 * 6, dtype=torch.float32, device=dev)
    table = table.reshape(40, 6)[1:]           # 24-byte offset, D*4 = 24
    ids = torch.tensor([0, 38, 39, 5], device=dev)
    got = embed_gather(table, ids)
    torch.cuda.synchronize()
    assert torch.equal(got, embed_gather_ref(table, ids))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    ids = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        embed_gather(torch.zeros((8, 4), dtype=torch.int8, device=dev), ids)
    with pytest.raises(ValueError, match="contiguous"):
        embed_gather(torch.zeros((8, 4), device=dev).t(), ids)
    with pytest.raises(ValueError, match="1-D on"):
        embed_gather(torch.zeros((8, 4), device=dev), ids.cpu())
    rows = torch.zeros((8, 4), device=dev)
    with pytest.raises(ValueError, match="dtype or width"):
        pm_combine(ids, ids, ids, rows, torch.zeros((8, 5), device=dev))


def test_runtime_on_the_card_equals_the_cpu(dev):
    """The same replayed stream served on CUDA (through the kernels) and on
    the CPU (through the plain versions): identical runs, identical rows,
    and the kernels launched once per served batch."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(2048, 8)).astype(np.float32)

    def run(device):
        live = DriftingZipfStream(2048, 8, zipf_a=1.2, arrival_rate=16,
                                  scenario="rotate", rotate_every=10, seed=5)
        cfg = ServeConfig(vocab=2048, batch_requests=16, keys_per_request=8,
                          cache_capacity=64, replan_every=6, refresh_every=0,
                          pipeline_depth=2, n_shards=4, summary=False)
        rt = ServingRuntime(table, cfg, device=device)
        return rt.run(ReplayStream.record(live, 50), 30,
                      collect_outputs=True)

    want = run("cpu")
    ops.reset_launch_counts()
    got = run(None)
    counts = ops.launch_counts()
    assert got.served == want.served > 0 and got.zero_served == 0
    assert got.miss_trace == want.miss_trace
    assert got.replan_rounds == want.replan_rounds
    for rid, rows in want.outputs.items():
        np.testing.assert_array_equal(got.outputs[rid], rows)
    assert counts["embed_gather"] >= len(got.miss_trace) > 0
    assert counts["pm_combine"] >= len(got.miss_trace)
