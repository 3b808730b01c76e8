from repro_torch.models.api import Model  # noqa: F401
