"""The falcon-h1-train-zipf cell: its configuration against the port's
published one, its work against a hand count, the readers of the
Falcon-H1 layers' branch marks on synthetic windows (the recompute's
marks inside the backward left out), and the cell's own run through
the harness on the CPU at a small size, sound and with its products in
TF32.  (A traced run needs the card's profiler: here the branch
readers read the program's own marks from a traced loop instead.)"""

import dataclasses
import math
import time

import pytest
import torch

from portbench import harness, work
from portbench.drivers import train as train_driver
from portbench.reference.steps import family
from portbench.tests import smallcells
from portbench.tests.test_portbench_reference import tf32_emulated

SPEC = harness.spec()
CELL = "falcon-h1-train-zipf"
NEW = ("train_ssm_forward_device_ms", "train_attn_forward_device_ms")
MS = 1_000_000
#: the cell at a size a CPU test holds: two layers of d_model 64, 4
#: heads of 16 (2 KV heads), a mixer of 4 heads of 16 in 2 groups with a
#: state of 32 (two of the scan's 16-state slices a group)
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab_size=512, ssm_heads=4, ssm_head_dim=16,
             ssm_groups=2, ssm_state=32)


def test_the_cell_runs_the_ports_published_configuration_cut_in_depth():
    from repro_torch.configs.registry import get_config
    c = harness.find_cell(CELL, SPEC)
    assert c.chips == 1 and c.traffic["name"] == "train-zipf"
    assert set(NEW) | {"train_mfu", "train_lookup_roofline",
                       "train_device_idle", "train_pm_host_ms"} \
        <= set(c.per_layer)
    assert c.end_to_end == ["train_tokens_per_s", "setup_s"]
    want = get_config("falcon-h1-34b")
    got = train_driver.model_config(c.config)
    assert dataclasses.replace(got, source=want.source) == \
        dataclasses.replace(want, n_layers=4)
    assert c.config["num_hidden_layers"] == c.config["n_layers"] == 4
    assert c.config["published"] == {"num_hidden_layers": 72,
                                     "n_layers": 72}


def test_falcon_h1_model_flops_by_hand():
    D, di, nh, V = 5120, 4096, 32, 261120
    C = di + 2 * 2 * 256                               # x, B, C
    mixer = D * (di + C + nh) + di * D                 # in_proj, out_proj
    assert mixer == 68321280
    attention = D * 20 * 128 * 2 + 2 * D * 4 * 128     # q, o; k, v
    assert attention == 31457280
    layer = mixer + attention + 3 * D * 21504
    assert layer == 430080000
    params = 4 * layer + D * V
    assert params == 3057254400                        # 3.0572 G
    cfg = harness.find_cell(CELL, SPEC).config
    assert family(cfg).matmul_params(cfg) == params
    causal = 4 * 6 * 2 * 2048 ** 2 * 20 * 128          # the causal half
    assert family(cfg).attention_flops(cfg, 2, 2048) == causal
    flops = work.model_flops(cfg, 2, 2048)
    assert flops == 6 * params * 4096 + causal
    assert flops == pytest.approx(7.565e13, rel=1e-3)


def step(t0, ssm, attn, mlp, layers=2, recompute=7.0):
    """A step's marks from ``t0`` as a rematerialised Falcon-H1 model
    makes them: forward, 1 ms of lookup, then each layer's ``ssm``,
    ``attn`` and ``mlp`` ms, 2 ms of head and loss to the backward,
    where each layer's recompute marks its branches again, ``recompute``
    ms apart, then the update's marks and the end."""
    marks, t = [("forward", t0)], t0 + MS
    for _ in range(layers):
        for part, ms in (("ssm", ssm), ("attn", attn), ("mlp", mlp)):
            marks.append(("forward/" + part, t))
            t += ms * MS
    marks.append(("backward", t + 2 * MS))
    t += 3 * MS
    for _ in range(layers):
        for part in ("ssm", "attn", "mlp"):
            marks.append(("forward/" + part, t))
            t += recompute * MS
    for part in ("update", "update/adagrad", "update/rows", "end"):
        marks.append((part, t))
        t += MS
    return [("train.mark." + p, s, s) for p, s in marks]


def window(spans):
    return harness.Window(harness.find_cell(CELL, SPEC), 0, 500 * MS, [],
                          sorted(spans, key=lambda s: (s[1], s[0])),
                          {"steps": 3})


def test_branch_readers_sum_the_forward_and_leave_the_recompute_out():
    spans = step(10 * MS, 4, 2, 9) + step(150 * MS, 6, 3, 9) \
        + step(480 * MS, 1, 1, 1)[:4]           # cut by the window's end
    w = window(spans + [("train.step", 10 * MS, 11 * MS)])
    # two layers a step, the mean of two whole steps
    assert harness.reader("train_ssm_forward_device_ms")(w) == \
        pytest.approx(2 * (4 + 6) / 2)
    assert harness.reader("train_attn_forward_device_ms")(w) == \
        pytest.approx(2 * (2 + 3) / 2)
    # the phase readers are unmoved by the branch marks
    assert harness.reader("train_forward_device_ms")(w) == \
        pytest.approx((1 + 2 * 15 + 2 + 1 + 2 * 18 + 2) / 2)


@pytest.mark.parametrize("name", NEW)
def test_branch_readers_find_nothing_without_branch_marks(name):
    plain = [s for s in step(10 * MS, 4, 2, 9)
             if "/ssm" not in s[0] and "/attn" not in s[0]]
    assert harness.reader(name)(window(plain)) is None
    assert harness.reader(name)(window([])) is None


def cell() -> harness.Cell:
    c = harness.find_cell(CELL, SPEC)
    c.config = dict(c.config, **SMALL)
    c.traffic = dict(c.traffic, seq=32)
    c.limits = dict(smallcells.TRAIN_LIMITS)
    return c


def run(seed: int):
    return harness.execute(harness.Run(cell(), seed, 0.5, False,
                                       torch.device("cpu"),
                                       time.perf_counter()))


def test_a_sound_run_is_correct():
    out, res = run(2 ** 31 + 13)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_the_programs_own_marks_give_the_branch_readers_their_steps():
    """A traced training loop of the small model on the CPU (its marks
    on the host's clock there): every whole step reads both branches."""
    from repro_torch.obs.trace import make_tracer
    from repro_torch.train.loop import LoopConfig, train_loop
    tracer = make_tracer(True)
    train_loop(train_driver.model_config(cell().config),
               LoopConfig(steps=3, batch=2, seq=32, kernel=True),
               tracer=tracer, device="cpu")
    spans = [(e["name"], e["t0_ns"], e["t1_ns"]) for e in tracer.events()]
    w = harness.Window(cell(), min(s for _, s, _ in spans),
                       max(e for _, _, e in spans), [], spans, {})
    ssm, attn = (harness.reader(n)(w) for n in NEW)
    fwd = harness.reader("train_forward_device_ms")(w)
    assert 0 < ssm < fwd and 0 < attn < fwd and ssm + attn < fwd


def test_the_control_fails_a_limit(monkeypatch):
    """Every product's operands in TF32 (emulated: the CPU has none)."""
    tf32_emulated(monkeypatch)
    out, res = run(21)
    nums = {k: v["value"] for k, v in res["checks"].items()}
    assert all(math.isfinite(v) for v in nums.values())
    assert res["correct"] is False, nums
