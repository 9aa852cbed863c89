from mjlab_tpu_torch.tasks.velocity.rl.runner import VelocityOnPolicyRunner  # noqa: F401
