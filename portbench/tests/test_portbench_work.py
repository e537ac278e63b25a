"""The benchmark's yardstick arithmetic against hand counts: model FLOPs
of both training configurations (each family's count in its reference
file), the lookup's least bytes, the 95th
percentile over all requests."""

import numpy as np
import pytest

from portbench import harness, peaks, work
from portbench.reference.steps import family
from portbench.drivers.serve import p95


def config(name):
    return harness.find_cell(
        {"nemotron-4-15b": "nemotron-train-zipf",
         "falcon-mamba-7b": "falcon-mamba-train-zipf"}[name],
        harness.spec()).config


def test_nemotron_model_flops_by_hand():
    D, F, V = 6144, 24576, 256000
    layer = 2 * D * D + 2 * D * 1024 + 2 * D * F      # q, o; k, v; mlp
    assert layer == 390070272
    params = 4 * layer + D * V
    assert family(config("nemotron-4-15b")).matmul_params(
        config("nemotron-4-15b")) == params == \
        3133145088
    attention = 4 * 6 * 2 * 2048 ** 2 * D              # causal half
    flops = work.model_flops(config("nemotron-4-15b"), 2, 2048)
    assert flops == 6 * params * 4096 + attention
    assert flops == pytest.approx(7.82e13, rel=2e-3)


def test_falcon_mamba_model_flops_by_hand():
    D, di, N, R, V = 4096, 8192, 16, 256, 65024
    layer = D * 2 * di + di * (R + 2 * N) + R * di + di * D
    assert layer == 105119744
    params = 8 * layer + D * V
    cfg = config("falcon-mamba-7b")
    assert family(cfg).matmul_params(cfg) == params
    assert family(cfg).attention_flops(cfg, 1, 2048) == 0
    assert work.model_flops(cfg, 1, 2048) == 6 * params * 2048
    assert work.model_flops(cfg, 1, 2048) == pytest.approx(1.36e13,
                                                           rel=2e-3)


def test_lookup_bytes_by_hand():
    cfg = {"d_model": 8}
    tok = np.array([[1, 2, 2], [3, 1, 5]])          # U = 4, T = 6
    assert work.lookup_bytes(cfg, tok, update=False) == (4 + 6) * 8 * 4
    assert work.lookup_bytes(cfg, tok, update=True) == \
        (4 + 6) * 8 * 4 + 5 * 4 * 8 * 4


def test_p95_is_taken_over_all_requests():
    assert p95(np.arange(1, 101, dtype=float)) == 95.0
    # the slowest five in a hundred are beyond it, the sixth is it
    v = np.concatenate([np.ones(94), [50.0], np.full(5, 1e3)])
    assert p95(np.random.default_rng(0).permutation(v)) == 50.0
    assert p95(np.array([3.0])) == 3.0


def test_peaks_of_the_h100():
    p = peaks.peaks_of("NVIDIA H100 80GB HBM3")
    assert p["flops"]["float32"] == 67e12
    assert p["hbm_bytes_per_s"] == 3.35e12
    with pytest.raises(KeyError):
        peaks.peaks_of("cpu")
