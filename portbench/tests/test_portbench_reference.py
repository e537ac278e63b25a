"""The training cells' check at a size a CPU test holds: the reference's
regenerated initial weights against the port's, its loss against the
port's model, sound runs read as correct, and runs with the timed path
broken underneath (a step that leaves the state unchanged, half the
batch left out, a token's row altered where it is produced) and the
control (the program's
products in TF32, emulated) read as not correct."""

import math

import numpy as np
import pytest
import torch

from portbench import faults
from portbench.drivers import train as train_driver
from portbench.reference import steps as ref_steps
from portbench.tests import smallcells

CELLS = ("nemotron-train-zipf", "falcon-mamba-train-zipf")


def port_model(config, seed):
    from repro_torch.models.model import init_model
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    return init_model(train_driver.model_config(config), gen)


@pytest.mark.parametrize("name", CELLS)
def test_reference_draws_the_ports_initial_weights(name):
    config = smallcells.cell(name).config
    seed = 2 ** 31 + 5
    port = dict(port_model(config, seed).named_parameters())
    ref = ref_steps.init_params(config, seed, "cpu")
    assert set(port) == set(ref)
    for k, v in ref.items():
        assert torch.equal(port[k].detach(), v), k


@pytest.mark.parametrize("name", CELLS)
def test_reference_loss_matches_the_ports_model(name):
    from repro_torch.models.model import loss_fn
    config = smallcells.cell(name).config
    tok = np.random.default_rng(0).integers(0, config["vocab_size"],
                                            (2, 24))
    lab = np.roll(tok, -1, axis=1)
    model = port_model(config, 3)
    t = torch.from_numpy(tok)
    logits, aux, _ = model({"tokens": t})
    want = float(loss_fn(logits, torch.from_numpy(lab), aux).detach())
    P = ref_steps.init_params(config, 3, "cpu")
    uniq, inv = torch.unique(t.reshape(-1), return_inverse=True)
    got = float(ref_steps.loss_of(config, P, P["embed"][uniq],
                                  inv.view(t.shape), torch.from_numpy(lab)))
    assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out, res = smallcells.run(name, seed=2 ** 31 + 9)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("fault", faults.TRAIN)
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_step_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    out, res = smallcells.run(name, seed=77)
    assert res["correct"] is False, res["checks"]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest even)."""
    i = x.float().contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


class TF32Products(torch.overrides.TorchFunctionMode):
    """Every matrix product's operands rounded to TF32: the tensor cores'
    input precision, where the CPU has no TF32."""

    PRODUCTS = {"matmul", "__matmul__", "einsum", "linear", "mm", "bmm"}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__name__", "") in self.PRODUCTS:
            # TF32 values, the gradient of an identity
            args = tuple(a + (tf32(a.detach()) - a.detach())
                         if isinstance(a, torch.Tensor)
                         and a.is_floating_point() else a for a in args)
        return func(*args, **kwargs)


def tf32_emulated(mp) -> None:
    """The control on the CPU: the program's loop with every matrix
    product's operands in TF32; the reference stays in fp32."""
    from repro_torch.train import loop
    train_loop = loop.train_loop

    def emulated(*a, **k):
        with TF32Products():
            return train_loop(*a, **k)
    mp.setattr(loop, "train_loop", emulated)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_a_limit(name, monkeypatch):
    """The program with its products in TF32, run through the harness,
    reads past at least one of the cell's limits."""
    tf32_emulated(monkeypatch)
    out, res = smallcells.run(name, seed=21)
    nums = {k: v["value"] for k, v in res["checks"].items()}
    assert all(math.isfinite(v) for v in nums.values())
    assert res["correct"] is False, nums
