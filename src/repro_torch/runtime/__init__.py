from .server import LMServer, LMSession, RecServer

__all__ = ["LMServer", "LMSession", "RecServer"]
