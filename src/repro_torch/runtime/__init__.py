from .server import GraphQueryServer, LMServer, LMSession, RecServer

__all__ = ["GraphQueryServer", "LMServer", "LMSession", "RecServer"]
