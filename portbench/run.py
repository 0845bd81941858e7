"""Command line of the benchmark::

    python3 -m portbench.run --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

The environment is pinned before the port is imported, so that the port
routes by its own built-in rules: no ``UDA_*`` variable of the caller
reaches it, the tune cache and the deployed sort path are empty, and its
kernels build into the checkout's ``uda_tpu_torch/_build/``. Exits with
a code other than 0, and prints no result, where the cell's card is
missing or a run fails.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402


def pin_environment() -> None:
    for key in [k for k in os.environ if k.startswith("UDA_")]:
        del os.environ[key]
    os.environ["UDA_TPU_TUNE_CACHE"] = ""
    os.environ["UDA_TPU_SORT_PATH"] = ""


if __name__ == "__main__":
    pin_environment()
    from portbench import harness

    sys.exit(harness.main(t0=T0))
