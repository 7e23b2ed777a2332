import time

T0 = time.perf_counter()  # set-up is timed from here, the harness's first line

import sys  # noqa: E402

from .run import main  # noqa: E402

sys.exit(main(t0=T0))
