"""Repeated commanded vertical hops."""

from mjlab_tpu_torch.tasks.jumping.config import g1  # noqa: F401  (registers tasks)
