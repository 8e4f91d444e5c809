from .serving import Completion, Request, ServeConfig, Server

__all__ = ["Server", "ServeConfig", "Request", "Completion"]
