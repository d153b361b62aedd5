"""cellbench: the benchmark of fftlab_torch on one NVIDIA card.

`python3 cellbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json once and prints one JSON line. The
harness finds everything a cell names by that name: the configuration
(`configs/<config>.json`), the traffic mix (`traffic/<mix>.json`), the
transform kind's work counts (`work/<kind>.py`), plain float64 reference
(`reference/<kind>.py`) and entry into the program (`program/<kind>.py`),
and one reader per per-layer metric (`metrics/<metric>.py`).
"""
