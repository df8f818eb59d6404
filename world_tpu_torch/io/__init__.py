from . import audio, parameterio

__all__ = ["audio", "parameterio"]
