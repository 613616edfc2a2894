"""Test processes compute on one CPU thread.

pytest-xdist runs several workers at once, and each would otherwise start
one OpenMP thread per core in torch, as would every rank process a test
spawns. The spin-waits of that many threads on too few cores slow small ops
by tens of times. pytest loads this file before `tests/conftest.py`.
"""

import os

# Inherited by spawned ranks and subprocesses; read when torch loads.
os.environ.setdefault("OMP_NUM_THREADS", "1")
os.environ.setdefault("MKL_NUM_THREADS", "1")

import torch  # noqa: E402

# for the case that torch was loaded before the environment above was set
torch.set_num_threads(1)
