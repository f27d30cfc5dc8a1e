from parelagmc_tpu_torch.uq.managers import MLMCManager  # noqa: F401
