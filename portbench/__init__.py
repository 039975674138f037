"""The benchmark of `lidargs_torch`, the PyTorch/CUDA port, on one H100.

`python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` (`run.py`). The harness is driven by
data: configurations (`configs/`), traffic mixes (`traffic/`), the limits
of each cell's check (`limits/`) and one reader per metric (`metrics/`),
found by name (`registry.py`). The plain PyTorch reference that decides
`correct` is `reference/` (it loads nothing of the port), the yardstick's
arithmetic `counts.py`, the trace reduction `tracing.py`, the prefix rows
`rows.py`; `calibrate.py` reads the check's numbers for the program, the
control and the faults over many seeds, to set the limits.
"""
