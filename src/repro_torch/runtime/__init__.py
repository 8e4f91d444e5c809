from .daemon import DaemonConfig, DaemonRequest, DaemonResponse, TranslationDaemon
from .serving import Completion, Request, ServeConfig, Server
from .trainer import StragglerDetector, TrainConfig, Trainer

__all__ = ["Server", "ServeConfig", "Request", "Completion", "Trainer", "TrainConfig",
           "StragglerDetector", "TranslationDaemon", "DaemonConfig", "DaemonRequest",
           "DaemonResponse"]
