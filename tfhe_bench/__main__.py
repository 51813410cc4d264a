import time

_T_START = time.perf_counter()  # set-up is counted from here

import sys  # noqa: E402

from tfhe_bench.run import main  # noqa: E402

sys.exit(main(t_start=_T_START))
