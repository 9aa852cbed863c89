"""Velocity-tracking task family."""

from mjlab_tpu_torch.tasks.velocity import config  # noqa: F401  (registers tasks)
