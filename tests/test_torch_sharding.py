"""The port's sharding rules against the reference's, for all ten published
configs on the production meshes' shapes, (16, 16) and (2, 16, 16).

No JAX mesh is built: the reference's rules read only ``mesh.shape`` and
``mesh.axis_names``, so they take a stand-in, and the port's take a
`MeshShape`.  Specs must be equal: the port's parameter specs, stacked as
`params_to_jax` stacks names (a leading None for the layer axis), against
`repro.launch.sharding.param_pspecs` over the reference's
`params_specs`; batch and cache specs for every architecture and shape;
`needs_zero` and `skip_reason` for all 40 combinations; and the shapes
and dtypes of `input_specs` against the reference's
``ShapeDtypeStruct``s.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

# the reference's dry-run module sets a host-device flag for the
# processes that run it; a test process keeps its own
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdryrun  # noqa: E402
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

import jax  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.launch import dryrun, sharding  # noqa: E402
from repro_torch.launch.mesh import MeshShape, axis_size  # noqa: E402
from repro_torch.models.model import STACKS  # noqa: E402

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def meshes(name):
    names, sizes = MESHES[name]
    return (MeshShape(names, sizes),
            SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes))))


def spec_tuple(p):
    return tuple(tuple(a) if isinstance(a, (list, tuple)) else a for a in p)


def jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(e.key) for e in path): leaf for path, leaf in flat}


@pytest.fixture(scope="module")
def param_shapes():
    """Per arch: the port's meta parameters and the reference's
    ``ShapeDtypeStruct`` tree (both in bf16, nothing allocated)."""
    return {arch: (dryrun.params_specs(get_config(arch)),
                   jdryrun.params_specs(jget_config(arch)))
            for arch in ARCH_IDS}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(param_shapes, arch, mesh_name):
    cfg, jcfg = get_config(arch), jget_config(arch)
    tmesh, jmesh = meshes(mesh_name)
    tshapes, jshapes = param_shapes[arch]
    for name, t in tshapes.items():
        assert t.device.type == "meta" and t.dtype == torch.bfloat16, name
    for zero_embed_head in (True, False):
        for zero_layers in (True, False, None):
            kw = dict(zero_embed_head=zero_embed_head,
                      zero_layers=zero_layers)
            got = sharding.param_pspecs(tshapes, cfg, tmesh, **kw)
            want = jax_paths(jsharding.param_pspecs(jshapes, jcfg, jmesh,
                                                    **kw))
            got_paths = stacked(got)
            assert set(got_paths) == set(want), (arch, kw)
            for path, spec in want.items():
                assert got_paths[path] == spec_tuple(spec), (arch, kw, path)


def stacked(specs):
    """The port's specs under the reference's paths, as `params_to_jax`
    stacks names: ``layers.<i>.<rest>`` -> ``layers/<rest>`` with a
    leading None for the layer axis (every layer's spec the same)."""
    out = {}
    for name, spec in specs.items():
        parts = name.split(".")
        if parts[0] in STACKS:
            path = "/".join([parts[0]] + parts[2:])
            spec = (None,) + spec
            assert out.setdefault(path, spec) == spec, name
        else:
            out["/".join(parts)] = spec
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_cache_and_skip_rules_equal_the_reference(mesh_name):
    """For every arch x shape: the skip reason; the batch specs (with the
    managed embedding's replica cache) or the cache specs; the shapes and
    dtypes of `input_specs`; and `needs_zero` per arch."""
    tmesh, jmesh = meshes(mesh_name)
    n = 0
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        assert sharding.needs_zero(cfg, tmesh) == \
            jsharding.needs_zero(jcfg, jmesh), arch
        for sname, shape in SHAPES.items():
            jshape = JSHAPES[sname]
            n += 1
            assert dryrun.skip_reason(cfg, shape) == \
                jdryrun.skip_reason(jcfg, jshape), (arch, sname)
            got = dryrun.input_specs(cfg, shape)
            want = jdryrun.input_specs(jcfg, jshape)
            assert set(got) == set(want), (arch, sname)
            if shape.kind == "decode":
                assert tuple(got["tokens"].shape) == want["tokens"].shape
                gcache = {k: v for k, v in got["cache"].items()
                          if k != "len"}
                wcache = {k: v for k, v in want["cache"].items()
                          if k != "len"}
                assert got["cache"]["len"] == 0
                _same_structs(gcache, wcache, (arch, sname))
                gspec = sharding.cache_pspecs(cfg, tmesh, gcache)
                wspec = jsharding.cache_pspecs(jcfg, jmesh, want["cache"])
                assert spec_tuple(wspec["len"]) == ()
                assert gspec == {k: spec_tuple(wspec[k]) for k in wcache}, \
                    (arch, sname)
                continue
            _same_structs(got, want, (arch, sname))
            extra = {"pm_cache_ids": (4096,),
                     "pm_cache_rows": (4096, cfg.d_model)}
            gspec = sharding.batch_pspecs(
                cfg, tmesh, {**{k: tuple(v.shape) for k, v in got.items()},
                             **extra})
            wspec = jsharding.batch_pspecs(
                jcfg, jmesh, {**want, **{
                    k: jax.ShapeDtypeStruct(s, np.float32)
                    for k, s in extra.items()}})
            assert gspec == {k: spec_tuple(v) for k, v in wspec.items()}, \
                (arch, sname)
    assert n == 40


def _same_structs(got, want, where):
    for k, t in got.items():
        assert tuple(t.shape) == tuple(want[k].shape), (where, k)
        assert str(t.dtype).removeprefix("torch.") == \
            np.dtype(want[k].dtype).name, (where, k)


def test_skips_are_the_seven_full_attention_long_500k():
    skipped = sorted((a, s) for a in ARCH_IDS for s, shape in SHAPES.items()
                     if dryrun.skip_reason(get_config(a), shape))
    assert len(skipped) == 7
    assert {s for _, s in skipped} == {"long_500k"}
    assert {a for a, _ in skipped} == set(ARCH_IDS) - dryrun.LONG_OK


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_placements_and_local_shapes(mesh_name):
    """A spec's placements on a mesh of those axes, and the shard shape:
    a tuple of axes shards one dimension over each of them, in order."""
    from torch.distributed.tensor import Replicate, Shard
    tmesh, _ = meshes(mesh_name)
    names, sizes = MESHES[mesh_name]
    if "pod" in names:
        spec = (("pod", "data"), None, "model")
        want = [Shard(0), Shard(0), Shard(2)]
        assert sharding.local_shape((64, 3, 32), spec, tmesh) == (2, 3, 2)
    else:
        spec = ("data", None, "model")
        want = [Shard(0), Shard(2)]
        assert sharding.local_shape((64, 3, 32), spec, tmesh) == (4, 3, 2)
    assert sharding.placements(spec, tmesh) == want
    assert sharding.placements((None, None), tmesh) == \
        [Replicate()] * len(names)
    with pytest.raises(ValueError):
        sharding.placements(("model", "model"), tmesh)
    with pytest.raises(ValueError):
        sharding.local_shape((9,), ("model",), tmesh)
    assert axis_size(tmesh, "model") == 16
    assert axis_size(tmesh, "pod") == (2 if "pod" in names else 1)
