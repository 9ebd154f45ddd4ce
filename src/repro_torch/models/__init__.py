"""Model substrate: config, layers, the dense family, registry, converter."""
from .config import ModelConfig
from . import registry
