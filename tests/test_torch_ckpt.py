"""Weights cross packages as checkpoints: a table the JAX package saves is
read by the port without JAX and served unchanged, and a checkpoint the
port writes loads in the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.pm.collectives import EmulatedBackend
from repro_torch.pm.embedding import planned_serve_lookup, probe_host


def tree(rng):
    return {"embed": rng.normal(size=(300, 12)).astype(np.float32),
            "blocks": [{"w": rng.normal(size=(4, 4)).astype(np.float32)},
                       {"w": np.arange(6, dtype=np.int32)}],
            "bf16": jnp.asarray(rng.normal(size=(5, 3))).astype(jnp.bfloat16)}


def test_port_reads_jax_checkpoint_and_serves_it(tmp_path):
    src = tree(np.random.default_rng(0))
    jckpt.save(str(tmp_path), src, step=7)
    flat, step = tckpt.load(str(tmp_path))
    assert step == 7
    assert set(flat) == {"embed", "blocks/0/w", "blocks/1/w", "bf16"}
    table = tckpt.table_from_numpy(flat["embed"], "cpu")
    np.testing.assert_array_equal(table.numpy(), src["embed"])
    bf = tckpt.table_from_numpy(flat["bf16"], "cpu")
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bf.view(torch.int16).numpy().view(np.uint16),
        np.asarray(src["bf16"]).view(np.uint16))
    # the loaded table serves the saved rows through the managed path
    cache = np.array([3, 17, 299], np.int32)
    tok = np.array([3, 5, 17, 5, 250, 299], np.int32)
    p = probe_host(cache, tok, 4)
    rows = planned_serve_lookup(
        table, EmulatedBackend(1).refresh_rows(table, torch.from_numpy(cache)),
        torch.from_numpy(p.buf_ids), torch.from_numpy(p.hit.astype(np.int32)),
        torch.from_numpy(p.cache_slot), torch.from_numpy(p.buf_slot),
        n_shards=4, kernel=True)
    np.testing.assert_array_equal(rows.numpy(), src["embed"][tok])


def test_load_into_structure_of_like(tmp_path):
    src = tree(np.random.default_rng(1))
    jckpt.save(str(tmp_path), src, step=3)
    like = {"embed": torch.zeros(300, 12), "bf16": torch.zeros(5, 3),
            "blocks": [{"w": torch.zeros(4, 4)},
                       {"w": torch.zeros(6, dtype=torch.int32)}]}
    got, step = tckpt.load(str(tmp_path), like)
    assert step == 3
    np.testing.assert_array_equal(got["blocks"][0]["w"], src["blocks"][0]["w"])
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.load(str(tmp_path), {"embed": torch.zeros(3, 12)})


def test_jax_reads_port_checkpoint(tmp_path):
    rng = np.random.default_rng(2)
    t = {"embed": torch.from_numpy(
             rng.normal(size=(40, 6)).astype(np.float32)),
         "bf16": torch.from_numpy(
             rng.normal(size=(2, 8)).astype(np.float32)).to(torch.bfloat16),
         "ids": [np.arange(3)]}
    tckpt.save(str(tmp_path), t, step=11, extra={"note": "port"})
    like = {"embed": jnp.zeros((40, 6)), "bf16": jnp.zeros((2, 8)),
            "ids": [jnp.zeros(3)]}
    got, step = jckpt.load(str(tmp_path), like)
    assert step == 11
    np.testing.assert_array_equal(got["embed"], t["embed"].numpy())
    np.testing.assert_array_equal(
        np.asarray(got["bf16"]).view(np.uint16),
        t["bf16"].view(torch.int16).numpy().view(np.uint16))
    # and back through the port, bit for bit
    flat, _ = tckpt.load(str(tmp_path))
    assert torch.equal(tckpt.table_from_numpy(flat["bf16"], "cpu"),
                       t["bf16"])
