"""The port's CPU tests run torch on ``THREADS`` intra-op threads.

The suite runs in several pytest workers at once, beside the multi-rank
gloo worlds some tests start, on a machine with few cores. torch's default
of one intra-op thread per core in every worker oversubscribes it, and its
parallel regions then wait on descheduled threads: a test of a tiny model
took 30x its time alone (5.7 s alone, 173 s in the suite). Each port test
module imports this one, so every worker that collects them runs torch on
``THREADS`` threads; the rank processes of a world set their own (one).
"""

import torch

THREADS = 2

torch.set_num_threads(THREADS)
