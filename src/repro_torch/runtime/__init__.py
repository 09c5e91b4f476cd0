from .server import GraphQueryServer, LMServer, LMSession, RecServer
from .trainer import HeartbeatMonitor, Trainer, TrainerConfig

__all__ = ["GraphQueryServer", "LMServer", "LMSession", "RecServer",
           "HeartbeatMonitor", "Trainer", "TrainerConfig"]
