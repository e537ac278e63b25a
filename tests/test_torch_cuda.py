"""The port on the card: each CUDA kernel against its plain version, bit
for bit, and the serving runtime, the training loop and decoding (every
model family, the recurrent ones' scan too) on CUDA against themselves
on the CPU.

Every test here needs a CUDA card and the CUDA toolkit; without a card
they skip.  This file imports no JAX, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.ckpt import checkpoint
from repro_torch.configs.registry import get_config
from repro_torch.data.batches import make_batch
from repro_torch.kernels import ops, ref
from repro_torch.kernels.adagrad_rows import adagrad_row_update
from repro_torch.kernels.embed_gather import embed_gather, embed_gather_path
from repro_torch.kernels.pm_forward import pm_combine
from repro_torch.kernels.ref import (adagrad_row_update_ref,
                                     embed_gather_ref, pm_combine_ref,
                                     scatter_rows_ref,
                                     segment_scatter_rows_ref)
from repro_torch.kernels.scatter_rows import (scatter_rows,
                                              segment_scatter_rows)
from repro_torch.launch.mesh import init_group
from repro_torch.models.layers import decode_attention, flash_attention
from repro_torch.models.model import (init_cache, init_model, load_params,
                                      loss_fn)
from repro_torch.models.moe import init_moe, moe_block
from repro_torch.models.ssm import linear_scan
from repro_torch.pm.collectives import (EmulatedBackend, make_backend,
                                        route_block)
from repro_torch.pm.embedding import make_state, pm_lookup
from repro_torch.train.loop import LoopConfig, checkpoint_tree, train_loop
from repro_torch.train.steps import (full_fp32_matmuls,
                                     make_prefill_decode_step, make_opt_init,
                                     make_serve_step)
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
                                   "adagrad_rows": 0, "scatter_rows": 0,
                                   "segment_scatter_rows": 0}


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
                                   "adagrad_rows": 1, "scatter_rows": 1,
                                   "segment_scatter_rows": 0}


@pytest.mark.parametrize("arch", ["nemotron-4-15b", "smollm-135m",
                                  "qwen2-vl-7b", "whisper-medium",
                                  "falcon-mamba-7b", "zamba2-1.2b"])
def test_train_loop_on_the_card_equals_the_cpu(dev, arch, tmp_path):
    """The same start (a checkpoint with a warm accumulator) trained on
    CUDA through the kernels and on the CPU through the plain versions:
    the loss traces agree within rtol 1e-4 / atol 1e-5 (matmuls sum in
    other orders on the card), and the
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
        assert counts["segment_scatter_rows"] >= 24
        assert counts["adagrad_rows"] == 0
    else:                        # fused arm: the sparse row update
        assert counts["adagrad_rows"] >= 24
        assert counts["segment_scatter_rows"] == 0


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_block_on_the_card_equals_the_cpu(dev, capacity_factor):
    """`moe_block` on CUDA against the same call on CPU copies: the same
    experts, slots and drops (at 0.5 some assignments drop), the output
    within rtol 1e-5 of its scale and the aux loss within rtol 1e-5."""
    full_fp32_matmuls()
    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    E, K, D = cfg.n_experts, cfg.top_k, cfg.d_model
    g = torch.Generator().manual_seed(2)
    p = init_moe(g, D, E, cfg.moe_d_ff, torch.float32)
    x = torch.randn((4, 16, D), generator=g)
    kw = dict(n_experts=E, top_k=K, capacity_factor=capacity_factor)
    r_cpu, r_dev = [], []
    out_c, aux_c, idx_c = moe_block(x, p, routes=r_cpu, **kw)
    out_d, aux_d, idx_d = moe_block(
        x.to(dev), {k: v.to(dev) for k, v in p.items()}, routes=r_dev, **kw)
    assert torch.equal(idx_d.cpu(), idx_c)
    assert torch.equal(r_dev[0].slot.cpu(), r_cpu[0].slot)
    assert torch.equal(r_dev[0].keep.cpu(), r_cpu[0].keep)
    assert bool(r_cpu[0].keep.all()) == (capacity_factor == 1.25)
    scale = float(out_c.abs().max())
    np.testing.assert_allclose(out_d.cpu().numpy(), out_c.numpy(),
                               rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(float(aux_d), float(aux_c), rtol=1e-5)


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-medium",
                                  "falcon-mamba-7b", "zamba2-1.2b"])
def test_forward_on_the_card_equals_the_cpu(dev, arch):
    """One forward of the smoke config over a batch with the family's
    extra inputs (image rows and M-RoPE positions, or frames) on CUDA
    against the CPU: logits within rtol 1e-4 / atol 1e-5."""
    full_fp32_matmuls()
    cfg = get_config(arch, smoke=True)
    model = init_model(cfg, torch.Generator().manual_seed(0))
    on_card = init_model(cfg, torch.Generator(device=dev).manual_seed(0))
    load_params(on_card, {k: v.detach() for k, v in
                          model.named_parameters()})
    batch = make_batch(cfg, 2, 16, np.random.default_rng(4))
    with torch.no_grad():
        want, _, _ = model(batch)
        got, _, _ = on_card({k: v.to(dev) for k, v in batch.items()})
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "whisper-medium",
                                  "zamba2-1.2b"])
def test_remat_gradients_on_the_card_equal_no_remat(dev, arch):
    """The smoke config's loss and gradients on the card with each layer
    rematerialised ("full" and "dots") equal those without, bit for
    bit: the recompute runs the same kernels on the same inputs."""
    full_fp32_matmuls()
    cfg = get_config(arch, smoke=True)
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(0))
    batch = {k: v.to(dev) for k, v in
             make_batch(cfg, 2, 16, np.random.default_rng(4)).items()}
    out = []
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        model.zero_grad(set_to_none=True)
        logits, aux, _ = model(batch, remat=remat, remat_policy=policy)
        loss = loss_fn(logits, batch["labels"], aux)
        loss.backward()
        out.append([loss.detach()] + [p.grad for p in model.parameters()])
    for got in out[1:]:
        for x, y in zip(got, out[0]):
            assert torch.equal(x, y)


@pytest.mark.parametrize("broadcast", [False, True])
def test_linear_scan_on_the_card_equals_the_cpu(dev, broadcast):
    """The chunked scan over 200 positions in chunks of 64 (the last
    ragged), its final state and the gradients of a weighted sum with
    respect to a, b and h0, on CUDA against the CPU: within rtol 1e-5 /
    atol 1e-5 times the largest magnitude."""
    g = torch.Generator().manual_seed(7)
    b_shape = (2, 200, 4, 8, 16)
    a_shape = (2, 200, 4, 1, 1) if broadcast else b_shape
    a = torch.rand(a_shape, generator=g) * 0.5 + 0.5
    b, w = (torch.randn(b_shape, generator=g) for _ in range(2))
    h0 = torch.randn((2, 4, 8, 16), generator=g)
    out = []
    for d in (torch.device("cpu"), dev):
        xs = [x.detach().to(d).requires_grad_(True) for x in (a, b, h0)]
        h, hf = linear_scan(*xs, 64)
        ((h * w.to(d)).sum() + hf.sum()).backward()
        out.append([t.detach().cpu() for t in (h, hf)]
                   + [x.grad.cpu() for x in xs])
    for want, got in zip(*out):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("window", [0, 300])
def test_flash_attention_on_the_card_equals_decode_attention(dev, window):
    """Blocked causal attention over 2000 positions (4 q blocks, the last
    ragged, against 2 kv blocks; GQA 8:2) against `decode_attention` with
    ``cache_len`` 2000 on the card, and against itself on the CPU: within
    rtol 1e-4 / atol 1e-5."""
    full_fp32_matmuls()
    g = torch.Generator().manual_seed(6)
    q = torch.randn((1, 2000, 8, 64), generator=g)
    k, v = (torch.randn((1, 2000, 2, 64), generator=g) for _ in range(2))
    got = flash_attention(q.to(dev), k.to(dev), v.to(dev), causal=True,
                          window=window)
    want = decode_attention(q.to(dev), k.to(dev), v.to(dev), 2000,
                            window=window)
    cpu = flash_attention(q, k, v, causal=True, window=window)
    for other in (want.cpu(), cpu):
        np.testing.assert_allclose(got.cpu().numpy(), other.numpy(),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-moe-30b-a3b",
                                  "mixtral-8x22b", "qwen2-vl-7b",
                                  "whisper-medium", "falcon-mamba-7b",
                                  "zamba2-1.2b"])
def test_decode_on_the_card_equals_the_cpu(dev, arch):
    """The fused prefill and four one-token steps on CUDA against the same
    on the CPU (one set of weights, the CPU run's greedy tokens fed to
    both; whisper's caches first take the encoder's output over the same
    frames): logits within rtol 1e-4 / atol 1e-5 at every step, and no
    kernel launched (the decode path's embedding is a plain index)."""
    cfg = get_config(arch, smoke=True)
    model = init_model(cfg, torch.Generator().manual_seed(0))
    on_card = init_model(cfg, torch.Generator(device=dev).manual_seed(0))
    load_params(on_card, {k: v.detach() for k, v in
                          model.named_parameters()})
    prompt = torch.randint(0, cfg.vocab_size, (2, 6),
                           generator=torch.Generator().manual_seed(3),
                           dtype=torch.int32)
    prefill, serve = make_prefill_decode_step(cfg), make_serve_step(cfg)
    ops.reset_launch_counts()
    c_cpu = init_cache(cfg, 2, 10, device="cpu")
    c_dev = init_cache(cfg, 2, 10)
    assert all(t.device.type == "cuda" for name, t in c_dev.items()
               if name != "len")
    if cfg.family == "encdec":
        frames = make_batch(cfg, 2, 6, np.random.default_rng(5))["frames"]
        with torch.no_grad():
            c_cpu["enc_out"] = model.encode(frames)
            c_dev["enc_out"] = on_card.encode(frames.to(dev))
    lg_c, c_cpu = prefill(model, c_cpu, prompt)
    lg_d, c_dev = prefill(on_card, c_dev, prompt.to(dev))
    for _ in range(4):
        np.testing.assert_allclose(lg_d.cpu().numpy(), lg_c.numpy(),
                                   rtol=1e-4, atol=1e-5)
        tok = lg_c.argmax(dim=-1, keepdim=True).to(torch.int32)
        lg_c, c_cpu = serve(model, c_cpu, tok)
        lg_d, c_dev = serve(on_card, c_dev, tok.to(dev))
    np.testing.assert_allclose(lg_d.cpu().numpy(), lg_c.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert c_dev["len"] == c_cpu["len"] == 10
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("D", [1, 8, 576, 6144])
def test_index_add_in_order_on_the_card_equals_the_cpu(dev, D):
    """The plain versions' in-order scatter-add (`segment_sum`, the dense
    arm's table gradient) gives the CPU's sequential sums bit for bit on
    the card, in every run: a Zipf token stream with long runs of
    duplicates, fp32."""
    T = 512
    rng = np.random.default_rng(D)
    idx = torch.from_numpy(rng.zipf(1.1, T) % 300).long()
    src = torch.from_numpy(rng.normal(size=(T, D)).astype(np.float32))
    want = ref.index_add_in_order(torch.zeros((300, D)), idx, src)
    for _ in range(2):
        got = ref.index_add_in_order(torch.zeros((300, D), device=dev),
                                     idx.to(dev), src.to(dev))
        assert torch.equal(raw(got.cpu()), raw(want))


def unaligned(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` whose first element is one element past a 16-byte
    boundary (rows keep their width)."""
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("D", [1, 3, 8, 576, 6144])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embed_gather_tma_and_word_paths(dev, D, dtype):
    """Both paths of the gather bit for bit against the plain version: the
    TMA path wherever the row is a multiple of 16 bytes and the table
    aligned, the word path for odd widths and unaligned views, and each
    path held to on aligned rows; ids outside [0, V), n = 0, and n that is
    no multiple of the ring (6 stages) or of a block's rows."""
    g = torch.Generator(device=dev)
    g.manual_seed(300 + D)
    V = 1000
    table = torch.randn((V, D), generator=g, device=dev).to(dtype)
    row_bytes = D * table.element_size()
    for src in (table, unaligned(table)):
        aligned = src.data_ptr() % 16 == 0 and row_bytes % 16 == 0
        for path in ("auto", "word") + (("tma",) if aligned else ()):
            for n in (0, 1, 5, 37, 1001):
                ids = torch.randint(-2, V + 3, (n,), generator=g,
                                    device=dev, dtype=torch.int32)
                if n >= 5:
                    ids[:5] = torch.tensor([0, V - 1, V, -1, V + 7])
                ops.reset_launch_counts()
                got = embed_gather(src, ids, path=path)
                torch.cuda.synchronize()
                assert got.shape == (n, D) and got.dtype == dtype
                assert torch.equal(raw(got), raw(embed_gather_ref(src, ids)))
                assert ops.launch_counts()["embed_gather"] == (1 if n else 0)
                if path == "auto":
                    want_path = "tma" if aligned else "word"
                    assert embed_gather_path(src, got) == want_path


def test_embed_gather_chooses_by_size(dev):
    """Aligned rows take the TMA path up to 32 MiB written and the word
    path above it; holding unaligned rows to the TMA path raises."""
    table = torch.randn((512, 6144), device=dev)      # rows of 24 KiB
    for n, want in ((1365, "tma"), (1366, "word"), (4096, "word")):
        ids = torch.randint(0, 513, (n,), device=dev)
        got = embed_gather(table, ids)
        assert embed_gather_path(table, got) == want
        assert torch.equal(raw(got), raw(embed_gather_ref(table, ids)))
    with pytest.raises(RuntimeError, match="launch failed"):
        embed_gather(unaligned(table[:8]), ids[:4], path="tma")
    torch.cuda.synchronize()


def zipf_tokens(seed: int, T: int, V: int) -> torch.Tensor:
    """Loader-like token ids: Zipf duplicates, with rows 0 and V - 1."""
    rng = np.random.default_rng(seed)
    tok = (rng.zipf(1.2, size=T) - 1) % V
    tok[:3] = [0, V - 1, 0]
    return torch.from_numpy(tok.astype(np.int32))


def reorder_tolerance(base, residual, grads):
    """Per element, the forward-error bound of an fp32 sum of a run taken
    in another order: 2 * (T - 1) * 2^-24 * sum |g| (T bounds any run's
    length), plus one rounding to bf16 where base is bf16."""
    T = grads.shape[0]
    mag = segment_scatter_rows_ref(torch.zeros_like(base, dtype=torch.float32),
                                   residual, grads.abs())
    tol = 2.0 * max(T - 1, 1) * 2.0 ** -24 * mag
    if base.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -8 * mag
    return tol


@pytest.mark.parametrize("D", [1, 3, 8, 576, 6144])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("one_run", [False, True])
def test_segment_scatter_rows_matches_plain(dev, D, dtype, one_run):
    """The segmented scatter equals its plain version run on CPU copies
    bit for bit (both add each run in sorted order); against the plain
    version on the card (`ref.index_add_in_order`) it is
    within the bound of a reordered fp32 sum.  Row V (the trash row) and
    every row no token names stay zero."""
    V, T = 3000, 512
    tok = zipf_tokens(D, T, V).to(dev)
    if one_run:
        tok[:] = 17
    res = ops.sorted_slots(tok, T)
    g = torch.Generator(device=dev)
    g.manual_seed(400 + D)
    grads = torch.randn((T, D), generator=g, device=dev).to(dtype)
    base = torch.zeros((V + 1, D), dtype=dtype, device=dev)
    ops.reset_launch_counts()
    got = segment_scatter_rows(base.clone(), res, grads)
    torch.cuda.synchronize()
    assert ops.launch_counts()["segment_scatter_rows"] == 1
    cpu = type(res)(*(x.cpu() for x in res))
    want = segment_scatter_rows_ref(base.cpu(), cpu, grads.cpu())
    assert torch.equal(raw(got.cpu()), raw(want))
    card = segment_scatter_rows_ref(base.clone(), res, grads)
    tol = reorder_tolerance(base, res, grads.float())
    assert bool(((got.float() - card.float()).abs() <= tol).all())
    named = torch.zeros(V + 1, dtype=torch.bool, device=dev)
    named[tok.long()] = True
    assert torch.count_nonzero(got[~named]) == 0


def test_segment_scatter_rows_mixed_types_and_unaligned(dev):
    """fp32 gradients into a bf16 base and bf16 into fp32, and gradients
    from an unaligned view (the element path): bit for bit against the
    plain version on CPU copies."""
    V, T, D = 500, 256, 24
    tok = zipf_tokens(7, T, V).to(dev)
    res = ops.sorted_slots(tok, T)
    cpu = type(res)(*(x.cpu() for x in res))
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    grads = torch.randn((T, D), generator=g, device=dev)
    for b_dtype, g_src in ((torch.bfloat16, grads),
                           (torch.float32, grads.to(torch.bfloat16)),
                           (torch.float32, unaligned(grads))):
        base = torch.zeros((V + 1, D), dtype=b_dtype, device=dev)
        got = segment_scatter_rows(base.clone(), res, g_src)
        torch.cuda.synchronize()
        want = segment_scatter_rows_ref(base.cpu(), cpu, g_src.cpu())
        assert torch.equal(raw(got.cpu()), raw(want))


def test_pm_lookup_sum_backward_takes_an_expanded_gradient(dev):
    """``pm_lookup(...).sum().backward()`` hands the backward an expanded
    gradient (stride 0): the segmented scatter takes it and gives the
    CPU's table gradient bit for bit."""
    V, D = 300, 24
    tok = zipf_tokens(11, 96, V).reshape(4, 24)
    cache = torch.full((16,), V, dtype=torch.int32)
    cached = torch.unique(tok)[::3][:16]
    cache[:cached.numel()] = cached
    g = torch.Generator()
    g.manual_seed(11)
    table = torch.randn((V, D), generator=g)
    grads = []
    for d in (torch.device("cpu"), dev):
        tab = table.to(d, copy=True).requires_grad_(True)
        cr = make_state(tab.detach(), cache.to(d)).cache_rows
        ops.reset_launch_counts()
        pm_lookup(tab, cache.to(d), cr, tok.to(d), 64,
                  kernel=True).sum().backward()
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert ops.launch_counts()["segment_scatter_rows"] == 1
        grads.append(tab.grad.cpu())
    assert torch.equal(raw(grads[1]), raw(grads[0]))


def test_every_wrapper_counts_its_launches(dev):
    """One call of each wrapper on CUDA tensors adds one to its own count
    and to no other."""
    V, n, D = 64, 8, 16
    table = torch.randn((V, D), device=dev)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    res = ops.sorted_slots(ids, n)
    calls = {
        "embed_gather": lambda: embed_gather(table, ids),
        "pm_combine": lambda: pm_combine(ids, ids, ids, table, table),
        "adagrad_rows": lambda: adagrad_row_update(
            table.clone(), torch.ones_like(table), ids,
            torch.ones((n, D), device=dev)),
        "scatter_rows": lambda: scatter_rows(table.clone(), ids,
                                             table[:n]),
        "segment_scatter_rows": lambda: segment_scatter_rows(
            torch.zeros_like(table), res, table[:n]),
    }
    for name, call in calls.items():
        ops.reset_launch_counts()
        call()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert counts[name] == 1
        assert sum(counts.values()) == 1


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
    res = ops.sorted_slots(ids, 4)
    with pytest.raises(ValueError, match="width"):
        segment_scatter_rows(rows, res, torch.zeros((4, 5), device=dev))
    with pytest.raises(ValueError, match="lengths"):
        segment_scatter_rows(rows, res, torch.zeros((3, 4), device=dev))
    with pytest.raises(ValueError, match="1-D on"):
        segment_scatter_rows(rows, type(res)(*(x.cpu() for x in res)),
                             torch.zeros((4, 4), device=dev))


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


@pytest.fixture
def nccl(dev, tmp_path):
    """The mesh at world size 1 over NCCL on the card (NCCL takes one card
    per rank, and the card machine has one)."""
    init_group(0, 1, str(tmp_path / "init"), device=dev, timeout_s=120)
    try:
        yield make_backend("mesh", 1)
    finally:
        dist.destroy_process_group()


def test_mesh_backend_on_the_card_equals_emulated(dev, nccl):
    """Every routed method of the one-rank mesh against the emulated
    backend on the card, both through the kernels: the same bits (the
    gradient is summed per run in sorted order on both)."""
    assert dist.get_backend() == "nccl"
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    V, D, T, M = 4096, 576, 512, 128
    table = torch.randn((V, D), generator=g, device=dev)
    emu = EmulatedBackend(1)
    ops.reset_launch_counts()
    ids = torch.sort(torch.randperm(V, generator=g, device=dev)[:M])[0]
    ids = ids.to(torch.int32)
    cap = route_block(ids[:M - 9].cpu().numpy(), V, 1, M)
    got = nccl.gather_rows_routed(table, ids, M - 9, cap, kernel=True)
    want = emu.gather_rows(table, ids, kernel=True)
    want[M - 9:] = 0
    assert torch.equal(raw(got), raw(want))
    tok = torch.randint(0, V, (T,), generator=g, device=dev,
                        dtype=torch.int32)
    tok[:64] = tok[64:128]
    gr = torch.randn((T, D), generator=g, device=dev)
    res = ops.sorted_slots(tok, T)
    got = nccl.scatter_row_grads(tok, gr, V, kernel=True, residual=res)
    want = emu.scatter_row_grads(tok, gr, V, kernel=True, residual=res)
    assert torch.equal(raw(got), raw(want))
    seg_ids, seg_g = ops.segment_rows(tok, gr, n_slots=T, pad_id=V,
                                      residual=res)
    accum = torch.rand((V, D), generator=g, device=dev)
    t1, a1 = table.clone(), accum.clone()
    nccl.update_rows(t1, a1, seg_ids, seg_g, lr=0.01, kernel=True)
    emu.update_rows(table, accum, seg_ids, seg_g, lr=0.01, kernel=True)
    assert torch.equal(raw(t1), raw(table))
    assert torch.equal(raw(a1), raw(accum))
    cache = torch.full((256,), V, dtype=torch.int32)
    cache[:200] = torch.sort(torch.randperm(V)[:200])[0]
    delta = torch.full((64,), V, dtype=torch.int32)
    delta[:40] = cache[:200:5]
    slots = torch.full((64,), 256, dtype=torch.int32)
    slots[:40] = torch.arange(0, 200, 5)
    rows = nccl.refresh_rows(table, cache.to(dev),
                             route_cap=route_block(cache.numpy(), V, 1, 256))
    assert torch.equal(raw(rows), raw(emu.refresh_rows(table, cache.to(dev))))
    base = torch.zeros((256, D), device=dev)
    got = nccl.refresh_rows_delta(table, base.clone(), delta, slots,
                                  kernel=True)
    want = emu.refresh_rows_delta(table, base.clone(), delta, slots,
                                  kernel=True)
    assert torch.equal(raw(got), raw(want))
    counts = ops.launch_counts()
    for name in ("embed_gather", "adagrad_rows", "scatter_rows",
                 "segment_scatter_rows"):
        assert counts[name] > 0, name


@pytest.mark.parametrize("arch", ["nemotron-4-15b", "smollm-135m"])
def test_mesh_train_loop_on_the_card(dev, nccl, arch):
    """The training loop on the one-rank NCCL mesh against the emulated
    loop on the card, both through the kernels."""
    cfg = get_config(arch, smoke=True)
    kw = dict(steps=20, batch=2, seq=16, refresh_every=2, pipeline_depth=1,
              kernel=True, log_every=0)
    want = train_loop(cfg, LoopConfig(**kw))
    got = train_loop(cfg, LoopConfig(collective="mesh", model_shards=1,
                                     **kw))
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4,
                               atol=1e-5)
    assert got.overflows == 0 and got.plans == want.plans


def test_mesh_runtime_on_the_card(dev, nccl):
    """The serving runtime on the one-rank NCCL mesh: exact rows."""
    table = np.random.default_rng(0).normal(size=(2048, 8)).astype(
        np.float32)
    live = DriftingZipfStream(2048, 8, zipf_a=1.2, arrival_rate=16,
                              scenario="rotate", rotate_every=10, seed=5)
    keys = {}
    stream = ReplayStream.record(live, 50)
    for wave in stream.per_round:
        for r in wave:
            keys[r.rid] = r.keys
    cfg = ServeConfig(vocab=2048, batch_requests=16, keys_per_request=8,
                      cache_capacity=64, pipeline_depth=2, summary=False,
                      collective="mesh", model_shards=1)
    res = ServingRuntime(table, cfg).run(stream, 30, collect_outputs=True)
    assert res.served > 0 and res.zero_served == 0
    for rid, rows in res.outputs.items():
        np.testing.assert_array_equal(rows, table[keys[rid]])
