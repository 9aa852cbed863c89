from mjlab_tpu_torch.tasks.tracking.rl.runner import (  # noqa: F401
    MotionTrackingOnPolicyRunner,
)
