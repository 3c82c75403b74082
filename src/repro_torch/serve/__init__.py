from repro_torch.serve.engine import Engine, ServeConfig

__all__ = ["ServeConfig", "Engine"]
