"""Every top-level function, class and method of the JAX package
(`src/repro`) has a twin of the same name in the same module of the
port (`src/repro_torch`), apart from the departures listed in
`DEPARTURES`, each with its reason.  The trees are read with `ast`;
neither package is imported.  A name the reference gains, or a twin the
port loses, fails here; so does a listed departure that has since gained
its twin (take it off the list).
"""

import ast
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

#: a module with no counterpart, and why
MODULE_DEPARTURES = {
    "kernels/blocking.py": "the Pallas kernels' block picking and "
                           "autotuning; the CUDA kernels size their own "
                           "launches",
}

_PALLAS = "a Pallas body or its wrapper; the CUDA kernel and its wrapper " \
          "take the public name"
_VJP = "a half of a jax.custom_vjp; the port's torch.autograd.Function " \
       "holds both"
_MODEL = "the functional model; the port writes it as DenseLM and its " \
         "modules, models/layouts.py and remat_call"

#: (module, name) with no twin of that name, and why
DEPARTURES = {
    ("kernels/embed_gather.py", "_gather_kernel"): _PALLAS,
    ("kernels/embed_gather.py", "_embed_gather"): _PALLAS,
    ("kernels/pm_forward.py", "_combine_kernel"): _PALLAS,
    ("kernels/pm_forward.py", "_pm_combine"): _PALLAS,
    ("kernels/pm_forward.py", "_pad_cols"): _PALLAS,
    ("kernels/pm_forward.py", "_jnp_scatter_set"):
        "jnp's scatter in the shared index arithmetic; the port's "
        "_TorchOps.scatter_set",
    ("kernels/pm_forward.py", "_np_scatter_set"):
        "numpy's scatter in the shared index arithmetic; the port's "
        "_NumpyOps.scatter_set",
    ("kernels/adagrad_rows.py", "_make_kernel"): _PALLAS,
    ("kernels/adagrad_rows.py", "_adagrad_row_update"): _PALLAS,
    ("kernels/scatter_rows.py", "_scatter_kernel"): _PALLAS,
    ("kernels/scatter_rows.py", "_scatter_rows"): _PALLAS,
    ("kernels/ops.py", "_on_tpu"):
        "the TPU test; a port wrapper runs its plain version on a CPU "
        "tensor and its kernel on a CUDA one",
    ("launch/dryrun.py", "_split_computations"):
        "the HLO parser; the port counts DTensor's collectives "
        "(StepCounter)",
    ("launch/dryrun.py", "_tuple_shapes"): "the HLO parser, as above",
    ("launch/dryrun.py", "collective_bytes"): "the HLO parser, as above",
    ("launch/sharding.py", "managed_table_sharding"):
        "the table's NamedSharding; the port's twin is "
        "launch/sharding.py::place_table",
    ("models/losses.py", "_pmax_stopgrad"): _VJP,
    ("models/losses.py", "_pmax_stopgrad_jvp"): _VJP,
    ("pm/embedding.py", "_pm_lookup_fwd"): _VJP,
    ("pm/embedding.py", "_pm_lookup_bwd"): _VJP,
    ("models/model.py", "forward"): _MODEL,
    ("models/model.py", "_dense_stack"): _MODEL,
    ("models/model.py", "_decoder_stack"): _MODEL,
    ("models/model.py", "_hybrid_stack"): _MODEL,
    ("models/model.py", "_ssm_stack"): _MODEL,
    ("models/model.py", "_encoder"): _MODEL,
    ("models/model.py", "_init_dense_layer"): _MODEL,
    ("models/model.py", "_init_encdec_layers"): _MODEL,
    ("models/model.py", "_init_ssm_layer"): _MODEL,
    ("models/model.py", "_constrain"): _MODEL,
    ("models/model.py", "_remat"): _MODEL,
    ("models/ssm.py", "_chunked_linear_scan"):
        "the lax.scan formulation; the port's twin is models/ssm.py::"
        "linear_scan",
    ("models/ssm.py", "_scan_op"): "its combine step, as above",
    ("train/steps.py", "pm_lookup_rows"):
        "the fused arm's row gather as a function; the port's step "
        "calls pm_lookup under no_grad in place",
    ("pm/collectives.py", "_all_to_all_route"):
        "shard_map's all-to-all routing; the port's MeshBackend calls "
        "torch.distributed's collectives in its methods",
    ("pm/collectives.py", "MeshBackend._check"):
        "the shard_map mesh's checks; the port's ModelGroup is checked "
        "where it is made (launch/mesh.py::make_model_mesh)",
    ("serve/runtime.py", "ServingRuntime._calibrate_overlap"):
        "the overlap calibration; an auto depth is the hill-climb's alone "
        "and the untimed warm-up dispatch is ServingRuntime._warm_up",
    ("serve/runtime.py", "ServingRuntime._overlap_backend_ok"):
        "the calibration's device test, gone with it",
    ("serve/runtime.py", "ServingRuntime.double_buffer"):
        "the alias of pipeline_depth >= 1; the port has the depth alone",
    ("serve/runtime.py", "ServingRuntime._managed_fn"):
        "one jitted lookup per route cap; the port's round calls "
        "planned_serve_lookup directly",
    ("pm/controller.py", "overlap_pays"):
        "the calibration's threshold, gone with it",
}


def definitions(path: Path) -> set:
    """The top-level functions and classes of a module, and the methods
    of its classes as ``Class.method``."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            out.update(f"{node.name}.{m.name}" for m in node.body
                       if isinstance(m, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)))
    return out


MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def test_the_trees_are_there():
    assert len(MODULES) > 40 and (PORT / "__init__.py").is_file()
    for module in MODULE_DEPARTURES:
        assert module in MODULES and not (PORT / module).exists(), module


@pytest.mark.parametrize("module", [m for m in MODULES
                                    if m not in MODULE_DEPARTURES])
def test_every_reference_name_has_a_twin(module):
    ref = definitions(REF / module)
    assert (PORT / module).is_file(), f"no port module {module}"
    missing = ref - definitions(PORT / module)
    unexplained = sorted(n for n in missing
                         if (module, n) not in DEPARTURES)
    assert not unexplained, f"{module}: no twin of {unexplained}"
    stale = sorted(n for (m, n) in DEPARTURES
                   if m == module and n not in missing)
    assert not stale, f"{module}: {stale} listed as departures, but " \
        "defined in both packages or no longer in the reference"
