"""The train steps, loops, state, schedules and checkpoints.
``gan_train_epoch`` (the JAX package's epoch as one ``lax.scan``) has no
counterpart: the loop runs ``gan_train_step`` once per batch."""

from .gan_step import gan_train_step, make_epoch_batches
from .schedules import cosine_annealing_lr
from .state import init_gan_state, make_optimizer, param_count
