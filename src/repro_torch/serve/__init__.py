"""LM serving of the port: slot-batched generation over the model's decode caches."""
from .engine import Engine, Request, ServeConfig

__all__ = ["Engine", "Request", "ServeConfig"]
