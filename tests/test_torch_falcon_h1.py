"""falcon_h1 (Falcon-H1-34B's parallel-hybrid layers) on the port, at a
small size with seeded random weights, against the benchmark's plain
reference (`portbench/reference/falcon_h1.py`, which computes the
recurrence in the Mamba-2 paper's chunked SSD form) and against the
published implementation (transformers' `FalconH1ForCausalLM`, where it
imports): logits, loss, every leaf's gradient, training steps through
`train_loop` with the managed embedding, the mixer's 16-state slices of
`selective_scan`, the layer's phase names, and decoding refused.  The
reference package has no twin of this family, so nothing here imports
JAX.  The one `cuda` test holds the mixer's kernel route to its plain
route on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_falcon_h1.py
"""

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import ARCH_IDS, PORT_ONLY, get_config
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.kernels import ops
from repro_torch.kernels.ref import selective_scan_ref
from repro_torch.launch import train as launch_train
from repro_torch.models import ssm
from repro_torch.models.model import init_cache, init_model, loss_fn
from repro_torch.obs.trace import PHASE_LISTENERS
from repro_torch.train import loop as train_loop_mod
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.steps import (make_prefill_decode_step,
                                     make_prefill_step, make_serve_step)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from portbench.reference import falcon_h1 as ref  # noqa: E402
from portbench.reference import steps as ref_steps  # noqa: E402

#: the smoke configuration with keys scaled by 0.5 in place of 0.011, so
#: that the scores, and with them RoPE, move the result
CFG = dataclasses.replace(get_config("falcon-h1-34b", smoke=True),
                          key_multiplier=0.5)


def as_dict(cfg) -> dict:
    """The configuration as the reference reads it."""
    return dict({f.name: getattr(cfg, f.name)
                 for f in dataclasses.fields(cfg)}, reference="falcon_h1")


def close(got, want, what, rel=1e-5):
    """fp32 against fp32 computed in another order (the chunked SSD
    form against the scan, `F.conv1d` against shifted sums, the full
    softmax against the blocked one): within ``rel`` of the largest
    magnitude of ``want``, about 100 times fp32's rounding of one
    product summed over the smoke widths."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * scale, (what, err, scale)


def test_registry_resolves_it_outside_the_reference_list():
    cfg = get_config("falcon-h1-34b")
    assert "falcon-h1-34b" in PORT_ONLY and "falcon-h1-34b" not in ARCH_IDS
    assert cfg.family == "falcon_h1" and cfg.d_inner == 4096
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (20, 4, 128)
    assert (cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state) == (32, 2, 256)
    # the published "34B": every parameter, the untied head included
    assert 33.5e9 < cfg.param_count() < 34.5e9
    assert get_config("falcon-h1-34b", smoke=True).family == "falcon_h1"
    with pytest.raises(KeyError):
        get_config("falcon-h1-0.5b")


def test_launch_train_runs_it_on_the_cpu(capsys):
    launch_train.main(["--arch", "falcon-h1-34b", "--smoke", "--steps", "3",
                       "--batch", "2", "--seq", "16", "--kernel", "--device",
                       "cpu"])
    out = capsys.readouterr().out
    assert "done: 3 steps" in out and "0 overflow" in out


def test_multipliers_from_json_lists_stay_hashable():
    cfg = dataclasses.replace(CFG, ssm_multipliers=[1, 2, 3, 4, 5],
                              mlp_multipliers=[0.5, 2.0])
    assert cfg.ssm_multipliers == (1, 2, 3, 4, 5)
    assert hash(cfg) == hash(dataclasses.replace(cfg))


def test_decoding_is_refused_with_a_reason():
    model = init_model(CFG, torch.Generator().manual_seed(0))
    tok = torch.zeros((1, 4), dtype=torch.long)
    for call in (lambda: init_cache(CFG, 1, 8, device="cpu"),
                 lambda: make_prefill_step(CFG),
                 lambda: make_prefill_decode_step(CFG),
                 lambda: make_serve_step(CFG),
                 lambda: model({"tokens": tok}, {"len": 4})):
        with pytest.raises(NotImplementedError, match="trained only"):
            call()


def test_logits_loss_and_every_gradient_match_the_reference():
    """Two chunks of the reference's SSD form (the second ragged), both
    groups, two 16-state slices a group; the model rematerialised as the
    train step runs it."""
    d = as_dict(CFG)
    model = init_model(CFG, torch.Generator().manual_seed(3))
    P = dict(ref.init_leaves(d, torch.Generator().manual_seed(3)))
    own = dict(model.named_parameters())
    assert set(own) == set(P)
    for k in P:
        assert torch.equal(own[k], P[k]), k
    rng = np.random.default_rng(1)
    tok = torch.from_numpy(rng.integers(0, CFG.vocab_size, (2, 300)))
    lab = torch.roll(tok, -1, dims=1)
    logits, _, _ = model({"tokens": tok}, remat=True)
    loss = loss_fn(logits, lab)
    loss.backward()

    with torch.no_grad():
        want = ref.hidden(P["embed"][tok], P, d) @ P["head"]
    close(logits.detach(), want, "logits")
    dense = [k for k in P if k != "embed"]
    for k in dense:
        P[k].requires_grad_(True)
    uniq, inv = torch.unique(tok.reshape(-1), return_inverse=True)
    rows = P["embed"][uniq].requires_grad_(True)
    ref_loss = ref_steps.loss_of(d, P, rows, inv.view(tok.shape), lab)
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()),
                                                 rel=1e-6)
    grads = torch.autograd.grad(ref_loss, [rows] + [P[k] for k in dense])
    close(own["embed"].grad[uniq], grads[0], "embed")
    for k, g in zip(dense, grads[1:]):
        close(own[k].grad, g, k)


def test_the_mixer_takes_16_state_slices_of_each_group(monkeypatch):
    calls = []

    def scan(u, delta, A, Bm, Cm, D, h0=None):
        calls.append((tuple(u.shape), tuple(A.shape), tuple(Bm.shape),
                      float(D.abs().sum())))
        return selective_scan_ref(u, delta, A, Bm, Cm, D, h0)
    monkeypatch.setattr(ssm, "selective_scan", scan)
    model = init_model(CFG, torch.Generator().manual_seed(0))
    model({"tokens": torch.zeros((2, 8), dtype=torch.long)})
    per_layer = CFG.ssm_groups * CFG.ssm_state // 16
    assert per_layer == 4
    assert len(calls) == CFG.n_layers * per_layer
    ch = CFG.d_inner // CFG.ssm_groups
    # the group's channels, the head's A on each of them and 16 states,
    # and no skip (D x is added once, outside)
    assert set(calls) == {((2, 8, ch), (ch, 16), (2, 8, 16), 0.0)}


def test_grouped_scan_is_the_recurrence_one_position_at_a_time():
    B, S, nh, hd, G, N = 2, 9, 4, 3, 2, 32
    g = torch.Generator().manual_seed(5)
    x = torch.randn(B, S, nh * hd, generator=g)
    dt = torch.rand(B, S, nh, generator=g) * 0.5
    A = -torch.rand(nh, generator=g) * 2
    Bm, Cm = (torch.randn(B, S, G * N, generator=g) for _ in range(2))
    y = ssm.grouped_scan(x, dt, A, Bm, Cm, G)
    h = torch.zeros(B, nh, hd, N)
    head = torch.arange(nh) // (nh // G)               # each head's group
    for t in range(S):
        Bt = Bm[:, t].view(B, G, N)[:, head]           # (B, nh, N)
        Ct = Cm[:, t].view(B, G, N)[:, head]
        a = torch.exp(dt[:, t] * A)[..., None, None]
        h = a * h + (dt[:, t, :, None] * x[:, t].view(B, nh, hd))[..., None] \
            * Bt[:, :, None, :]
        want = (h * Ct[:, :, None, :]).sum(-1).reshape(B, -1)
        close(y[:, t], want, f"position {t}", rel=1e-6)


def test_the_layer_names_its_branches_in_the_forward_and_the_recompute():
    seen = []
    PHASE_LISTENERS.append(seen.append)
    try:
        model = init_model(CFG, torch.Generator().manual_seed(0))
        logits, _, _ = model({"tokens": torch.zeros((1, 8),
                                                    dtype=torch.long)},
                             remat=True)
        seen.append("backward")
        logits.sum().backward()
    finally:
        PHASE_LISTENERS.remove(seen.append)
    layer = ["forward/ssm", "forward/attn", "forward/mlp"]
    assert seen == layer * CFG.n_layers + ["backward"] \
        + layer * CFG.n_layers


def test_train_loop_steps_match_the_reference(monkeypatch):
    """Three steps of `train_loop` with the managed embedding and the
    fused sparse arm (the kernels' plain versions on the CPU) against
    the reference's AdaGrad steps on the loader's tokens: each loss, and
    each leaf's change after the last step by the harness's measure."""
    B, S, seed, lr, n = 2, 64, 11, 0.01, 3
    d = as_dict(CFG)
    made = []

    def make_watched(*a, **k):
        fn = make(*a, **k)

        def step(model, opt_state, batch):
            made.append(model)
            return fn(model, opt_state, batch)
        return step
    make = train_loop_mod.make_train_step
    monkeypatch.setattr(train_loop_mod, "make_train_step", make_watched)
    res = train_loop(CFG, LoopConfig(steps=n, batch=B, seq=S, lr=lr,
                                     pm=True, kernel=True, seed=seed),
                     device="cpu")
    corpus = SyntheticCorpus(CFG.vocab_size, seed=seed)
    batches = [(t, np.roll(t, -1, axis=1))
               for t in (corpus.tokens((B, S)) for _ in range(n))]
    want, _ = ref_steps.train(d, seed, batches, lr, torch.device("cpu"),
                              change_after=n)
    # fp32 in another order: the losses read 7.7e-8 apart and the changes
    # 1.2e-7 at this seed; a step that left the table's rows or a dense
    # leaf unchanged moves both by 1e-4 or more
    np.testing.assert_allclose(res.losses, want.losses, rtol=1e-6)
    got = ref_steps.change_norms(d, seed, dict(made[-1].named_parameters()))
    med = float(np.median(list(want.change.values())))
    for k, v in want.change.items():
        assert abs(got[k] - v) <= 1e-5 * max(v, med), (k, got[k], v)


def test_published_implementation_gives_the_same_logits():
    """The same weights in transformers' `FalconH1ForCausalLM` (its
    plain torch path, eager attention), at the smoke widths with the
    published multipliers but the keys' and the head's, which are
    raised so that the scores and the logits are not all near zero."""
    tf = pytest.importorskip("transformers")
    cfg = dataclasses.replace(CFG, lm_head_multiplier=0.5)
    hf_cfg = tf.FalconH1Config(
        vocab_size=cfg.vocab_size, hidden_size=cfg.d_model,
        intermediate_size=cfg.d_ff, num_hidden_layers=cfg.n_layers,
        num_attention_heads=cfg.n_heads, num_key_value_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, rms_norm_eps=cfg.norm_eps,
        mamba_d_ssm=cfg.d_inner, mamba_n_heads=cfg.ssm_heads,
        mamba_d_head=cfg.ssm_head_dim, mamba_n_groups=cfg.ssm_groups,
        mamba_d_state=cfg.ssm_state, mamba_d_conv=cfg.ssm_conv,
        mamba_chunk_size=16, mamba_conv_bias=True, mamba_proj_bias=False,
        mamba_norm_before_gate=False, mamba_rms_norm=True,
        rope_theta=cfg.rope_theta, tie_word_embeddings=False,
        embedding_multiplier=cfg.embedding_multiplier,
        lm_head_multiplier=cfg.lm_head_multiplier,
        attention_in_multiplier=cfg.attention_in_multiplier,
        attention_out_multiplier=cfg.attention_out_multiplier,
        key_multiplier=cfg.key_multiplier,
        ssm_in_multiplier=cfg.ssm_in_multiplier,
        ssm_out_multiplier=cfg.ssm_out_multiplier,
        ssm_multipliers=list(cfg.ssm_multipliers),
        mlp_multipliers=list(cfg.mlp_multipliers),
        attn_implementation="eager")
    hf = tf.FalconH1ForCausalLM(hf_cfg).eval()
    model = init_model(cfg, torch.Generator().manual_seed(4))
    own = {k: v.detach() for k, v in model.named_parameters()}
    # every published weight from the port's, (in, out) -> (out, in)
    names = {"model.embed_tokens.weight": own["embed"],
             "lm_head.weight": own["head"].T,
             "model.final_layernorm.weight": own["final_norm.scale"]}
    for i in range(cfg.n_layers):
        p, q = f"layers.{i}", f"model.layers.{i}"
        names.update({
            f"{q}.input_layernorm.weight": own[f"{p}.norm1.scale"],
            f"{q}.pre_ff_layernorm.weight": own[f"{p}.norm2.scale"],
            f"{q}.mamba.in_proj.weight": own[f"{p}.mamba.in_proj"].T,
            f"{q}.mamba.conv1d.weight": own[f"{p}.mamba.conv_w"][:, None],
            f"{q}.mamba.conv1d.bias": own[f"{p}.mamba.conv_b"],
            f"{q}.mamba.dt_bias": own[f"{p}.mamba.dt_bias"],
            f"{q}.mamba.A_log": own[f"{p}.mamba.A_log"],
            f"{q}.mamba.D": own[f"{p}.mamba.D_skip"],
            f"{q}.mamba.norm.weight": own[f"{p}.mamba.norm_scale"],
            f"{q}.mamba.out_proj.weight": own[f"{p}.mamba.out_proj"].T})
        for w, h in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"),
                     ("wo", "o_proj")):
            names[f"{q}.self_attn.{h}.weight"] = own[f"{p}.attn.{w}"].T
        for w, h in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                     ("w_down", "down_proj")):
            names[f"{q}.feed_forward.{h}.weight"] = own[f"{p}.mlp.{w}"].T
    theirs = dict(hf.named_parameters())
    assert set(theirs) == set(names)
    with torch.no_grad():
        for k, v in names.items():
            theirs[k].copy_(v)
        tok = torch.from_numpy(
            np.random.default_rng(2).integers(1, cfg.vocab_size, (2, 40)))
        want = hf(input_ids=tok).logits
        got, _, _ = model({"tokens": tok})
    close(got, want, "logits")


@pytest.mark.cuda
def test_mixer_kernel_route_equals_its_plain_route_on_the_card(monkeypatch):
    """The mixer at 2 groups of 4 heads of 64 and a state of 64 on the
    card: through the selective-scan kernels (4 slices a group) against
    the same mixer with the scan's plain version, output and gradients
    (fp32 sums in another order: the kernel's sequential states against
    the doubling scan's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    D, nh, hd, G, N, B, S = 256, 8, 64, 2, 64, 2, 640
    gen = torch.Generator(device=dev).manual_seed(0)
    p = {k: v.requires_grad_(True) for k, v in ssm.init_mamba2_mixer(
        gen, D, nh, hd, G, N, 4, torch.float32).items()}
    x = torch.randn(B, S, D, device=dev, generator=gen)
    mult = get_config("falcon-h1-34b").ssm_multipliers
    kw = dict(n_groups=G, ssm_state=N, in_multiplier=0.25,
              multipliers=mult, eps=1e-5)

    def run():
        y = ssm.mamba2_mixer(x, p, **kw)
        g = torch.autograd.grad((y * y).sum(), list(p.values()))
        return [y.detach()] + list(g)
    ops.reset_launch_counts()
    kernel = run()
    counts = ops.launch_counts()
    assert counts["selective_scan"] == G * N // 16
    assert counts["selective_scan_backward"] == G * N // 16
    monkeypatch.setattr(ssm, "selective_scan", selective_scan_ref)
    plain = run()
    for name, a, b in zip(["y"] + list(p), kernel, plain):
        close(a, b, name, rel=1e-4)
    assert math.isfinite(float(kernel[0].sum()))
