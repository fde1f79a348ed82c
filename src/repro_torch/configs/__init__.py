from repro_torch.configs.registry import TINY, get_config, get_smoke_config

__all__ = ["get_config", "get_smoke_config", "TINY"]
