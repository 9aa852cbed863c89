"""Vertical-jump task family."""

from mjlab_tpu_torch.tasks.jump.config import g1  # noqa: F401  (registers tasks)
