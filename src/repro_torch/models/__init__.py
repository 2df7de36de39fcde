from .convert import params_from_jax
from .lm import Model
from .registry import build, build_from_config, extend_cache

__all__ = ["Model", "build", "build_from_config", "extend_cache", "params_from_jax"]
