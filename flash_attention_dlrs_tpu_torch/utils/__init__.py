from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .metrics import MetricsLogger, ThroughputMeter

__all__ = [
    "MetricsLogger",
    "ThroughputMeter",
    "latest_step",
    "restore_checkpoint",
    "save_checkpoint",
]
