from .pickle_loader import (
    EasyDict,
    PersistentStub,
    load_network_pkl,
    generator_from_stub,
    load_generator,
)
from .native import load_native, save_native

__all__ = [
    "EasyDict",
    "PersistentStub",
    "load_network_pkl",
    "generator_from_stub",
    "load_generator",
    "load_native",
    "save_native",
]
