from mjlab_tpu_torch.tasks.velocity.config import g1, go1  # noqa: F401
