from .server import Server

__all__ = ["Server"]
