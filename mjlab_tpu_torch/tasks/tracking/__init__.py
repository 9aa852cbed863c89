"""Motion-tracking (imitation) task family."""

from mjlab_tpu_torch.tasks.tracking.config import g1  # noqa: F401  (registers tasks)
