from parelagmc_tpu_torch.physics.darcy import DarcySolver  # noqa: F401
