"""The train steps, the scanned epoch, loops, state, schedules and
checkpoints. ``gan_train_epoch`` is the counterpart of the JAX package's epoch
as one ``lax.scan``: on a CUDA device the step captured once as a CUDA graph
and replayed once per batch (``step_graph.py``)."""

from .gan_step import gan_train_epoch, gan_train_step, make_epoch_batches
from .schedules import cosine_annealing_lr
from .state import init_gan_state, make_optimizer, param_count
