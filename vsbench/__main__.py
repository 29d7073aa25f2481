"""``python3 -m vsbench``: see ``vsbench/run.py``."""

import time

T_START = time.perf_counter()

import sys  # noqa: E402

from vsbench.run import main  # noqa: E402

sys.exit(main(t_start=T_START))
