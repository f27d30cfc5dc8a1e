from parelagmc_tpu_torch.samplers.pde import SPDESampler  # noqa: F401
