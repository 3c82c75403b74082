from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.scheduler import Request, Scheduler, admit_many

__all__ = ["ServeConfig", "Engine", "Request", "Scheduler", "admit_many"]
