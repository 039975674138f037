"""`python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>`.

Set-up is counted from the process's start: the kernel's record of it
where /proc has one, else the first line here. The program keeps its nvcc
builds in a fixed directory of the checkout (`build/lidargs_torch/`).
"""
import time

T_FIRST = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402


def process_start() -> float:
    """The process's start on the `time.perf_counter` clock."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return T_FIRST
    return time.perf_counter() - max(age, 0.0)


if __name__ == "__main__":
    _start = min(process_start(), T_FIRST)
    from portbench.run import main

    sys.exit(main(sys.argv[1:], _start))
