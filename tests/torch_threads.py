"""One torch intra-op thread in each test process.

The suite runs under pytest-xdist, several worker processes on one host.
torch's default of one OpenMP thread per core in each of them puts several
times as many threads as cores on the CPU, and the plain versions' many
small tensor operations then spend their time in threads waiting on each
other.  Every port test module imports this one, so a worker that runs any
of them computes torch operations on one thread.
"""
import torch

torch.set_num_threads(1)
