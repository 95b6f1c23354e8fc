"""Worker for the two-process torch.distributed test of the port's data
parallelism (tests/test_torch_parallel.py), the counterpart of
tests/multiprocess_worker.py:

    python torch_multiprocess_worker.py SPEC RANK WORLD PORT OUT_JSON

SPEC holds the tiny models as numpy trees (the JAX initialisers'), the
styles and JAX's full-batch one-step reference. The worker joins a gloo
group over 127.0.0.1 and runs `stylemc_torch.bench.dp_ranks`' three
checks on one torch thread: (a) a data-parallel find_direction step over
the group against the references, (b) append_multihost's process-major
rows, (c) Collector(cross_process=True) on the union of the reports.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from stylemc_torch.bench.dp_ranks import main  # noqa: E402

if __name__ == "__main__":
    torch.set_num_threads(1)
    sys.exit(main(sys.argv[1:]))
