from parelagmc_tpu_torch.utils.timing import SteadyCostLedger, TimeManager  # noqa: F401
