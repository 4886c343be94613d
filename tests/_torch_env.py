"""One intra-op thread for torch in the port's tests.

The suite runs in several pytest workers at once.  Torch's default pool
(one thread a core in every process) oversubscribes the CPU, and its
small-tensor loops then run 20-25x slower than alone.  Importing this
module sets torch to one intra-op thread in this process; ``env()`` is the
environment for a subprocess that a port test starts, and spawned ranks
call ``torch.set_num_threads(1)`` themselves."""

import os

import torch

THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}

torch.set_num_threads(1)


def env(**extra) -> dict:
    """``os.environ`` with one torch thread, plus ``extra``."""
    return dict(os.environ, **THREADS, **extra)
