"""Faults and controls planted in the program underneath a run, to show
the cells' checks catch them: the test suite plants them at a small size
on the CPU, `tools/control.py` at a cell's own size on the chip, both
through the harness's own run and verdict.  Each takes an object with
pytest's ``monkeypatch.setattr`` (`Patches` outside pytest) and breaks
one thing the timed path computes, or (a control) puts the nearest
precision below the configuration's in the program's place."""

from __future__ import annotations


class Patches:
    """``setattr`` that `undo` reverts, for use outside pytest."""

    def __init__(self):
        self._undo = []

    def setattr(self, obj, name, value):
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self._undo:
            setattr(*self._undo.pop())


def unchanged(mp) -> None:
    """A training step that returns its state unchanged."""
    from repro_torch.pm.collectives import EmulatedBackend
    from repro_torch.train import steps
    mp.setattr(steps, "adagrad_update", lambda *a, **k: None)
    mp.setattr(EmulatedBackend, "update_rows", lambda *a, **k: None)


def half_batch(mp) -> None:
    """Half of the batch left out, the loss the mean over the rest (half
    the positions of a one-sequence batch)."""
    from repro_torch.train import steps
    loss = steps.loss_fn

    def half(out, labels, aux=0.0):
        B, S = labels.shape
        if B > 1:
            return loss(out[:B // 2], labels[:B // 2], aux)
        return loss(out[:, :S // 2], labels[:, :S // 2], aux)
    mp.setattr(steps, "loss_fn", half)


def token_altered(mp) -> None:
    """One token's row altered where the training step's lookup produces
    it."""
    from repro_torch.train import steps
    lookup = steps.pm_lookup

    def altered(*a, **k):
        h = lookup(*a, **k).clone()
        h.view(-1, h.shape[-1])[0] += 1.0
        return h
    mp.setattr(steps, "pm_lookup", altered)


def answer_altered(mp, keys_per_request: int) -> None:
    """Each served request's first row altered where the serving lookup
    produces it."""
    from repro_torch.serve import runtime
    lookup = runtime.planned_serve_lookup

    def altered(*a, **k):
        out = lookup(*a, **k).clone()
        out[::keys_per_request, 0] += 1.0
        return out
    mp.setattr(runtime, "planned_serve_lookup", altered)


def tf32_products(mp) -> None:
    """The training control: the program's fp32 products in TF32 (the
    step's own switch, which turns TF32 off, turns it on); the reference
    stays in fp32."""
    import torch
    from repro_torch.train import steps

    def on():
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    mp.setattr(steps, "full_fp32_matmuls", on)


def bf16_table(mp) -> None:
    """The serving control: the runtime handed the table's rows rounded
    through bfloat16; the reference draws the fp32 table again."""
    import torch
    from repro_torch.serve import runtime
    init = runtime.ServingRuntime.__init__

    def rounded(self, table, *a, **k):
        with torch.no_grad():
            table.copy_(table.to(torch.bfloat16))
        init(self, table, *a, **k)
    mp.setattr(runtime.ServingRuntime, "__init__", rounded)


TRAIN = (unchanged, half_batch, token_altered)
