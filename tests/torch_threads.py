"""One intra-op CPU thread for torch in every test process.

pytest-xdist starts several workers on one machine, and each worker's torch
would otherwise start one OpenMP thread per core: six workers then spin
about six times as many threads as there are cores, and a CPU test of the
port runs up to twenty times slower than alone. Every ``test_torch_*.py``
imports this module (``test_torch_threads.py`` holds them to it), and xdist
workers collect every test file, so the pin holds in each worker from
collection on, for the JAX package's torch-parity tests too.
``OMP_NUM_THREADS`` is set as well, for the subprocesses the tests start.
"""

import os

import torch

os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)
