"""One intra-op thread for torch in every process that runs the port's tests.

Every ``tests/test_torch_*.py`` and ``tests/_torch_parallel_worker.py``
imports this module before its first torch work (``test_torch_serving.py``
checks that they do). A pytest-xdist worker collects every test module
before it runs any, so the whole worker, module-scoped fixtures included,
runs on one thread from collection on. They import it as ``import
torch_threads``: pytest puts ``tests/`` on ``sys.path`` for the files it
collects, as Python does for a script run from it, whereas ``from tests
import ...`` finds another installed package named ``tests`` where there
is one.

Why: the tier-1 command runs 6 xdist workers on an 8-core machine, and each
worker's torch otherwise starts its default pool of 8 intra-op threads, 48
spinning threads on 8 cores. The port's CPU tests are thousands of tiny
operations, and each waits on a thread barrier that the other workers' threads
contend for. Measured on such a machine: one case of ``test_torch_epoch``
took 3.6 s alone on 8 threads and 315 s beside the other workers on 8 threads
each; six copies of it at once on one thread each took 2.9-3.1 s apiece; the
whole command fell from 1,284 s to 484 s.

The setting lives here and not in ``wordgesture_gan_tpu_torch``: a user's own
CPU run keeps torch's default.
"""

import torch

torch.set_num_threads(1)
