"""Manipulation task family."""

from mjlab_tpu_torch.tasks.manipulation.config import yam  # noqa: F401  (registers tasks)
