"""The benchmark of rayforce_tpu_torch, the PyTorch and CUDA port.

`run.py` runs one cell of `BENCHMARK.json` once (`harness.py`); what
belongs to one configuration, traffic mix, metric or kind of query
lives in files of its own: `configs/<config>.json` with
`data/<generator>.py`, `traffic/<mix>.json`, `metrics/<metric>.py`,
`reference/<kind>.py`. `sets.py` runs sets of runs and prints each
metric's spread; `control.py` gives the readings the comparison's
limits are set from. Nothing here imports JAX or the JAX package.
"""
