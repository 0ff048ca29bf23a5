"""The benchmark of the PyTorch / CUDA port (`datafusion_tpu_torch`).

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once. Everything a cell needs is found
by name: its configuration (`configs/<config>.json`, whose `maker` names
a table maker in `makers/`), its traffic mix (`mixes/<traffic>.json`,
whose `reference` names a module in `reference/`), and one reader per
per-layer metric (`metrics/<metric>.py`). Nothing here imports jax or the
JAX package.
"""
