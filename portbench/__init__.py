"""The benchmark of the PyTorch and CUDA port (`repro_torch`) on one H100.

`run.py` is the entry point; `BENCHMARK.json` at the repository root
names the cells.  Everything that belongs to one configuration, traffic
mix, per-layer metric or cell sits in a file of its own, found by name:

* ``configs/<name>.json``: a model configuration as it is run;
* ``reference/<family>.py``: the plain PyTorch reference of a family;
* ``traffic/<name>.json``: the parameters of a traffic mix, read by
  `generator`; its ``kind`` names the driver, ``drivers/<kind>.py``;
* ``metrics/<name>.py``: the reader of one per-layer metric;
* ``limits/<cell>.json``: the limits of a cell's correctness check.

Nothing here imports JAX or the JAX package, and the reference imports
nothing of the port.
"""
