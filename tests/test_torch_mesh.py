"""The port's vocab-parallel mesh (`pm.collectives.MeshBackend` over
`torch.distributed`) against the JAX package and the dense references.

Four gloo ranks are started once for the module (`launch.mesh.run_ranks`);
each runs every check of `_mesh_ranks.rank_main` and returns numpy
results, which the tests below hold against:

* `table[ids]` bit for bit (routed and replicated gathers, a skewed batch
  that falls back, refreshes, served rows), pads reading zero;
* the dense gradient (`np.add.at`) within rtol 1e-6 (gradient blocks);
* the port's `EmulatedBackend.update_rows` bit for bit (AdaGrad blocks);
* `repro.train.loop.train_loop` (JAX, emulated) and the port's emulated
  loop within rtol 1e-4 / atol 1e-5 (20-step loss traces from a warm
  checkpoint, as tests/test_torch_train.py explains; tied, untied, and
  untied over two data shards), with no overflow step and the replicated
  parameters bitwise equal on all ranks.

At one rank (a gloo group of one in this process) the port's backend and
serving runtime are held against `repro`'s `MeshBackend` on a one-device
mesh (``kernel=False``).  `repro`'s mesh fused step is no oracle here: its
tests fail in this environment (ROADMAP Queue 3).
"""

import contextlib
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _mesh_ranks as R
import repro.serve as J
import repro_torch.serve as P
from repro.ckpt import checkpoint as jckpt
from repro.configs.registry import get_config as jget_config
from repro.kernels import ops as jops
from repro.launch.mesh import make_model_mesh as jmake_model_mesh
from repro.models.model import init_model as jinit_model
from repro.optim.optimizers import AdaGradState
from repro.pm.collectives import MeshBackend as JMeshBackend
from repro.pm.collectives import route_block_cap as jroute_block_cap
from repro.train.loop import LoopConfig as JLoopConfig
from repro.train.loop import train_loop as jtrain_loop
from repro_torch.ckpt import checkpoint
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops
from repro_torch.launch.mesh import init_group, run_ranks
from repro_torch.pm.collectives import (EmulatedBackend, MeshBackend,
                                        make_backend, route_block,
                                        route_block_cap)
from repro_torch.train.loop import LoopConfig

N = 4
PINNED = dict(batch=2, seq=16, refresh_every=2, pipeline_depth=1,
              log_every=0, steps=20)
RUNS = {"tied": "smollm-135m", "untied": "nemotron-4-15b",
        "data-shards": "nemotron-4-15b"}
# the loader's batch over two data shards: the mesh's miss bound must
# cover the whole batch, which every rank compacts (bounded per data
# shard, as the reference's mesh bounds it, this run overflows)
DATA_SHARDS = dict(n_shards=2, batch=4, seq=64, cache_capacity=64)
CKPT_STEP = 19
SERVE = {"auto": {}, "constrained": {"cache_capacity": 64,
                                     "pipeline_depth": 2}}
RTOL, ATOL = 1e-4, 1e-5


def warm_start(arch: str, path) -> str:
    """The JAX smoke model's init with a warm AdaGrad accumulator, in the
    JAX on-disk format."""
    jp = jinit_model(jget_config(arch, smoke=True), jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    acc = jax.tree_util.tree_map(
        lambda x: (rng.uniform(0.5, 1.5, size=x.shape) * 1e-4)
        .astype(np.float32), jp)
    jckpt.save(str(path), {"params": jp, "opt": AdaGradState(acc)}, 0)
    return str(path)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    kws = {name: dict(PINNED, kernel=True,
                      init_from=warm_start(arch, d / f"init-{name}"))
           for name, arch in RUNS.items()}
    kws["data-shards"].update(DATA_SHARDS)
    kws["untied"].update(ckpt_dir=str(d / "ckpt-mesh"),
                         ckpt_every=CKPT_STEP)
    return d, kws


@pytest.fixture(scope="module", autouse=True)
def started(setup):
    """The four ranks, started when the module starts: they run in their
    own processes while this one computes the JAX references."""
    _, kws = setup
    runs = {name: (RUNS[name], kw) for name, kw in kws.items()}
    serve = [(N, 4096, 16, 24, 0, knobs) for knobs in SERVE.values()]
    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(run_ranks, R.rank_main, N, 0, runs, serve,
                        timeout_s=300)
        yield fut
        fut.exception()          # waits; a failure surfaces in `ranks`


@pytest.fixture(scope="module")
def ranks(started):
    """What the four ranks returned, in rank order."""
    return started.result()


@pytest.fixture(scope="module")
def emulated(setup):
    """The same runs through `repro`'s loop (JAX) and the port's emulated
    loop: ``{name: (jax result, port result, port model)}``."""
    d, kws = setup
    out = {}
    for name, kw in kws.items():
        jkw = {k: v for k, v in kw.items()
               if k not in ("kernel", "ckpt_dir", "ckpt_every")}
        want = jtrain_loop(jget_config(RUNS[name], smoke=True),
                           JLoopConfig(**jkw))
        pkw = dict(kw)
        if "ckpt_dir" in pkw:
            pkw["ckpt_dir"] = str(d / "ckpt-emulated")
        got, model = R.train_capture(get_config(RUNS[name], smoke=True),
                                     LoopConfig(**pkw))
        out[name] = (want, got, model)
    return out


@contextlib.contextmanager
def one_rank(path):
    """A gloo process group of one rank in this process."""
    init_group(0, 1, str(path / "init"), device="cpu", timeout_s=60)
    try:
        yield make_backend("mesh", 1)
    finally:
        dist.destroy_process_group()


def bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def full(ranks, key):
    """The ranks' blocks of one result, stacked in rank order."""
    return np.concatenate([r["backend"][key] for r in ranks])


# ------------------------------------------------ index stage against JAX

@pytest.mark.parametrize("m,n", [(1, 1), (7, 1), (32, 4), (33, 4), (64, 8),
                                 (100, 3), (512, 4), (4, 8)])
def test_route_block_cap_matches_jax(m, n):
    assert route_block_cap(m, n) == jroute_block_cap(m, n)


@pytest.mark.parametrize("seed", range(6))
def test_owner_segments_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 9))
    block = int(rng.integers(1, 40))
    M = int(rng.integers(1, 64))
    nv = int(rng.integers(0, min(M, n * block) + 1))
    ids = rng.integers(0, n * block, M).astype(np.int32)
    ids[:nv] = np.sort(rng.choice(n * block, nv, replace=False))
    want = jops.owner_segments(jnp.asarray(ids), nv, n, block)
    for nval in (nv, torch.tensor(nv)):
        got = ops.owner_segments(torch.from_numpy(ids), nval, n, block)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -------------------------------------------- one rank against repro's mesh

def jax_one_device(x: dict):
    """`repro`'s `MeshBackend` on a one-device mesh (``kernel=False``),
    every method on the inputs ``x``, in one jitted program (eager
    `shard_map` calls compile one by one, seconds each)."""
    jbe = JMeshBackend(jmake_model_mesh(1))
    V, T = R.V, R.T

    def run(table, accum, even, ids, tok, g, delta, slots):
        seg_ids, seg_g = jops.segment_rows(tok, g, n_slots=T, pad_id=V)
        return {"routed": jbe.gather_rows_routed(table, even, R.N_EVEN),
                "gather": jbe.gather_rows(table, ids),
                "grad": jbe.scatter_row_grads(tok, g, V),
                "seg": (seg_ids, seg_g),
                "update": jbe.update_rows(table, accum, seg_ids, seg_g,
                                          lr=0.05),
                "delta": jbe.refresh_rows_delta(
                    table, jnp.zeros((R.C, R.D)), delta, slots)}

    args = [jnp.asarray(x[k]) for k in ("table", "accum", "even")] + \
        [jnp.asarray(np.clip(x["mixed"], 0, V - 1))] + \
        [jnp.asarray(x[k]) for k in ("tok", "g", "delta", "slots")]
    return jax.tree_util.tree_map(np.asarray, jax.jit(run)(*args))


def test_one_rank_backend_matches_jax(tmp_path):
    x = R.inputs(0)
    want = jax_one_device(x)
    V = R.V
    t = lambda a: torch.from_numpy(np.array(a))    # noqa: E731
    with one_rank(tmp_path) as be:
        assert isinstance(be, MeshBackend) and be.n_shards == 1
        tab = be.place_table(x["table"])
        cap = route_block(x["even"][:R.N_EVEN], V, 1, R.M)
        assert cap == R.M
        got = be.gather_rows_routed(tab, t(x["even"]), R.N_EVEN,
                                    cap).numpy()
        np.testing.assert_array_equal(bits(got), bits(want["routed"]))
        # the replicated gather (JAX reads row 0 for a pad; ours reads 0)
        ids = np.clip(x["mixed"], 0, V - 1)
        np.testing.assert_array_equal(
            bits(be.gather_rows(tab, t(ids)).numpy()), bits(want["gather"]))
        for fn in (be.scatter_row_grads, be.scatter_row_grads_psum):
            np.testing.assert_allclose(
                fn(t(x["tok"]), t(x["g"]), V).numpy(), want["grad"],
                rtol=1e-6, atol=1e-7)
        seg_ids, seg_g = want["seg"]
        tb, ab = be.place_table(x["table"]), be.place_table(x["accum"])
        be.update_rows(tb, ab, t(seg_ids), t(seg_g), lr=0.05)
        np.testing.assert_allclose(tb.numpy(), want["update"][0], rtol=1e-6)
        np.testing.assert_allclose(ab.numpy(), want["update"][1], rtol=1e-6)
        got_d = be.refresh_rows_delta(tab, torch.zeros((R.C, R.D)),
                                      t(x["delta"]), t(x["slots"]))
        np.testing.assert_array_equal(bits(got_d.numpy()),
                                      bits(want["delta"]))


def lookup_inputs(seed: int = 3):
    """A serving batch (8 requests x 6 keys) against a 40-row cache."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((R.V, R.D)).astype(np.float32)
    cache = np.full(48, R.V, np.int32)
    cache[:40] = np.sort(rng.choice(R.V, 40, replace=False))
    tokens = rng.integers(0, R.V, (8, 6)).astype(np.int32)
    return table, cache, tokens, table[np.minimum(cache, R.V - 1)] * \
        (cache < R.V)[:, None]


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("M", [8, 64])
def test_serve_lookup_matches_jax(n_shards, M):
    """The probe-on-device serving lookup and the emulated vocab-parallel
    gather (`shard_partial_sum`) against JAX's, exactly; ``M = 8`` leaves
    misses over capacity (zeros, flagged)."""
    from repro.pm import embedding as JE
    from repro_torch.pm import embedding as PE
    table, cache, tokens, rows = lookup_inputs()
    want = JE.serve_lookup(jnp.asarray(table), jnp.asarray(cache),
                           jnp.asarray(rows), jnp.asarray(tokens), M,
                           n_shards=n_shards)
    got = PE.serve_lookup(torch.from_numpy(table), torch.from_numpy(cache),
                          torch.from_numpy(rows), torch.from_numpy(tokens),
                          M, n_shards=n_shards, kernel=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(np.asarray(want.overflow).any()) == (M == 8)
    ids = tokens.reshape(-1)
    np.testing.assert_array_equal(
        bits(PE.shard_partial_sum(torch.from_numpy(table),
                                  torch.from_numpy(ids), n_shards).numpy()),
        bits(JE.shard_partial_sum(jnp.asarray(table), jnp.asarray(ids),
                                  n_shards)))


def test_one_rank_serve_lookup_and_refresh_match_jax(tmp_path):
    """`serve_lookup` over the one-rank mesh (the host does not know its
    miss set, so it takes the replicated gather) and `refresh_cache`
    through the mesh backend, against JAX's on a one-device mesh."""
    from repro.launch.mesh import axis_size as jaxis_size
    from repro.pm import embedding as JE
    from repro_torch.launch.mesh import axis_size
    from repro_torch.pm import embedding as PE
    table, cache, tokens, rows = lookup_inputs()
    jbe = JMeshBackend(jmake_model_mesh(1))
    want = JE.serve_lookup(jnp.asarray(table), jnp.asarray(cache),
                           jnp.asarray(rows), jnp.asarray(tokens), 16,
                           backend=jbe)
    jstate = JE.refresh_cache(JE.make_state(jnp.asarray(table),
                                            jnp.asarray(cache)),
                              backend=jbe)
    with one_rank(tmp_path) as be:
        assert axis_size(be.mesh) == jaxis_size(jbe.mesh, "model") == 1
        assert axis_size(be.mesh, "data") == 1
        tab = be.place_table(table)
        got = PE.serve_lookup(tab, torch.from_numpy(cache),
                              torch.from_numpy(rows),
                              torch.from_numpy(tokens), 16, kernel=True,
                              backend=be)
        state = PE.refresh_cache(PE.make_state(tab, torch.from_numpy(cache)),
                                 backend=be)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(bits(state.cache_rows.numpy()),
                                  bits(jstate.cache_rows))


def serve_config(mod, **kw):
    args = dict(vocab=2048, batch_requests=16, keys_per_request=8,
                cache_capacity=256, replan_every=6, refresh_every=0,
                pipeline_depth=1, summary=False, collective="mesh",
                model_shards=1)
    args.update(kw)
    return mod.ServeConfig(**args)


def serve_stream(mod):
    table = np.random.default_rng(0).normal(size=(2048, 8)).astype(
        np.float32)
    live = mod.DriftingZipfStream(2048, 8, zipf_a=1.2, arrival_rate=16,
                                  scenario="rotate", rotate_every=10, seed=5)
    return table, mod.ReplayStream.record(live, 50)


def test_one_rank_runtime_matches_jax(tmp_path):
    table, stream = serve_stream(J)
    want = J.ServingRuntime(table, serve_config(J, kernel=False)).run(
        stream, 12, collect_outputs=True)
    table, stream = serve_stream(P)
    with one_rank(tmp_path):
        rt = P.ServingRuntime(table, serve_config(P), device="cpu")
        got = rt.run(stream, 12, collect_outputs=True)
    assert want.served > 0 and got.zero_served == 0
    for f in ("served", "requeues", "replans", "replan_rounds",
              "plan_miss_capacities", "overflow_batches"):
        assert getattr(got, f) == getattr(want, f), f
    assert set(got.outputs) == set(want.outputs)
    for rid, rows in want.outputs.items():
        np.testing.assert_array_equal(bits(got.outputs[rid]), bits(rows))


def test_a_failing_rank_stops_the_others():
    """A rank that fails its check raises here with its traceback, and the
    ranks left waiting for it are stopped, well inside the timeout."""
    import multiprocessing
    import time
    before = set(multiprocessing.active_children())   # the module's ranks
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1: check failed"):
        run_ranks(R.fail_on_rank, 2, 1, timeout_s=60)
    assert time.monotonic() - t0 < 60
    assert set(multiprocessing.active_children()) <= before


def test_mesh_is_refused_without_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_backend("mesh", 1)


# --------------------------------------------- four ranks: the backend

def test_every_rank_ran_its_block(ranks):
    assert [r["backend"]["rank"] for r in ranks] == list(range(N))


def test_vocab_must_divide_the_ranks(ranks):
    for r in ranks:
        assert r["backend"]["refused"] == [True, True, True]


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("om", [None, "host"])
@pytest.mark.parametrize("name", ["even", "skew"])
def test_routed_gather_is_exact(ranks, name, om, kernel):
    x = R.inputs(0)
    nv = R.N_EVEN if name == "even" else 24
    want = np.zeros((R.M, R.D), np.float32)
    want[:nv] = x["table"][x[name][:nv]]
    for r in ranks:
        got = r["backend"][f"routed_{name}_{kernel}_{om}"]
        np.testing.assert_array_equal(bits(got), bits(want))


def test_skewed_batches_fall_back(ranks):
    """The skewed buffer (24 ids of one owner, blocks of 16) gets no block
    from the host (`route_block`) and falls back in each of its calls, as
    do the three calls per kernel made without the host's ids; every
    other routed call stays routed unless its own per-owner count says
    otherwise."""
    x = R.inputs(0)
    assert route_block(x["skew"][:24], R.V, N, R.M) == 0
    falls = [route_block(ids, R.V, N, m) == 0
             for ids, m in ((x["even"][:R.N_EVEN], R.M),
                            (x["skew"][:24], R.M), (x["cache"], R.C),
                            (x["delta"], R.N_DELTA))]
    fall = 2 * (3 + sum(falls))
    for r in ranks:
        c = r["backend"]["counts"]
        assert c["fallback"] == fall
        assert c["routed"] == 2 * 7 - fall   # 7 routed calls per kernel


@pytest.mark.parametrize("kernel", [False, True])
def test_replicated_gather_is_exact(ranks, kernel):
    x = R.inputs(0)
    ids = x["mixed"]
    want = np.where((ids < R.V)[:, None],
                    x["table"][np.minimum(ids, R.V - 1)], 0.0)
    for r in ranks:
        np.testing.assert_array_equal(
            bits(r["backend"][f"gather_{kernel}"]), bits(want))


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("path", ["grad", "grad_nores", "grad_psum"])
def test_gradient_blocks_match_the_dense_sum(ranks, path, kernel):
    x = R.inputs(0)
    want = np.zeros((R.V, R.D), np.float32)
    np.add.at(want, x["tok"], x["g"])
    got = full(ranks, f"{path}_{kernel}")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kernel", [False, True])
def test_update_rows_equals_the_emulated_update(ranks, kernel):
    x = R.inputs(0)
    tok, g = torch.from_numpy(x["tok"]), torch.from_numpy(x["g"])
    seg_ids, seg_g = ops.segment_rows(tok, g, n_slots=R.T, pad_id=R.V)
    tab = torch.from_numpy(x["table"].copy())
    acc = torch.from_numpy(x["accum"].copy())
    EmulatedBackend(1).update_rows(tab, acc, seg_ids, seg_g, lr=0.05,
                                   kernel=kernel)
    got_t = np.concatenate([r["backend"][f"update_{kernel}"][0]
                            for r in ranks])
    got_a = np.concatenate([r["backend"][f"update_{kernel}"][1]
                            for r in ranks])
    np.testing.assert_array_equal(bits(got_t), bits(tab.numpy()))
    np.testing.assert_array_equal(bits(got_a), bits(acc.numpy()))
    assert not np.array_equal(got_t, x["table"])


def test_refreshes_are_exact(ranks):
    x = R.inputs(0)
    cache = x["cache"]
    want = np.where((cache < R.V)[:, None],
                    x["table"][np.minimum(cache, R.V - 1)], 0.0)
    want_d = np.zeros((R.C, R.D), np.float32)
    keep = x["slots"] < R.C
    want_d[x["slots"][keep]] = x["table"][x["delta"][keep]]
    for r in ranks:
        b = r["backend"]
        for key in ("refresh", "refresh_host"):
            np.testing.assert_array_equal(bits(b[key]), bits(want))
        for kernel in (False, True):
            np.testing.assert_array_equal(bits(b[f"delta_{kernel}"]),
                                          bits(want_d))


# --------------------------------------------- four ranks: training

@pytest.mark.parametrize("name", list(RUNS))
def test_mesh_trace_matches_jax(ranks, emulated, name):
    want = emulated[name][0]
    for r in ranks:
        got = r["train"][name]
        assert len(got["losses"]) == len(want.losses) == PINNED["steps"]
        np.testing.assert_allclose(got["losses"], want.losses, rtol=RTOL,
                                   atol=ATOL)
        assert got["overflows"] == want.overflows == 0
        assert got["plans"] == want.plans >= 1
        assert got["refreshes"] == want.refreshes


@pytest.mark.parametrize("name", list(RUNS))
def test_mesh_matches_the_emulated_port(ranks, emulated, name):
    _, want, model = emulated[name]
    got = ranks[0]["train"][name]
    np.testing.assert_allclose(got["losses"], want.losses, rtol=RTOL,
                               atol=ATOL)
    params = R.replicated(model)
    assert set(got["params"]) == set(params)
    for k, v in params.items():
        np.testing.assert_allclose(got["params"][k], v, rtol=RTOL,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name", list(RUNS))
def test_replicas_stay_bitwise_equal_on_every_rank(ranks, name):
    runs = [r["train"][name] for r in ranks]
    assert len({r["digest"] for r in runs}) == 1
    assert all(r["losses"] == runs[0]["losses"] for r in runs)
    V = get_config(RUNS[name], smoke=True).vocab_size
    assert all(r["embed_rows"][0] == V // N for r in runs)


@pytest.mark.parametrize("name", list(RUNS))
def test_mesh_training_routes_its_misses(ranks, name):
    for r in ranks:
        assert r["train"][name]["counts"]["routed"] > 0


def test_mesh_checkpoint_holds_the_whole_table(ranks, setup, emulated):
    """Rank 0 writes the gathered blocks in the JAX on-disk format; it
    matches the emulated run's checkpoint of the same step."""
    d, kws = setup
    step = f"step_{CKPT_STEP:07d}"
    got, s1 = checkpoint.load(str(d / "ckpt-mesh" / step))
    want, s2 = checkpoint.load(str(d / "ckpt-emulated" / step))
    assert s1 == s2 == CKPT_STEP and set(got) == set(want)
    V = get_config("nemotron-4-15b", smoke=True).vocab_size
    assert got["params/embed"].shape[0] == V
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


# --------------------------------------------- four ranks: serving

@pytest.mark.parametrize("i,name", list(enumerate(SERVE)))
def test_mesh_serves_exact_rows(ranks, i, name):
    runs = [r["serve"][i] for r in ranks]
    for run in runs:
        assert run["served"] > 0 and run["zero_served"] == 0
        assert run["outputs"] == run["served"] and run["bad"] == 0
        assert run["counts"]["routed"] > 0
    for f in ("served", "requeues", "replans"):
        assert len({run[f] for run in runs}) == 1, f
