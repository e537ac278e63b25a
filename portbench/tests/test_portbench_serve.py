"""The serving cells' check at a size a CPU test holds: sound runs read
as correct; a run whose served rows are altered where the lookup
produces them, and the control (the runtime's table in bfloat16, the
precision below the table's fp32), read as not correct."""

import pytest

from portbench import faults
from portbench.tests import smallcells

CELLS = ("nemotron-serve-zipf", "nemotron-serve-uniform")


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out, res = smallcells.run(name, seed=2 ** 31 + 3, seconds=1.0)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 100 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert res["checks"]["rows_checked_short"]["value"] == 0
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("name", CELLS)
def test_an_altered_answer_is_not_correct(name, monkeypatch):
    faults.answer_altered(monkeypatch,
                          smallcells.cell(name).traffic["keys_per_request"])
    out, res = smallcells.run(name, seed=8, seconds=1.0)
    assert res["correct"] is False
    assert res["checks"]["rows_wrong"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_exact_comparison(name, monkeypatch):
    """The runtime handed the table's rows in bfloat16, run through the
    harness: its served rows fail the exact comparison."""
    faults.bf16_table(monkeypatch)
    out, res = smallcells.run(name, seed=4, seconds=1.0)
    assert res["correct"] is False
    assert res["checks"]["rows_wrong"]["value"] > 0
