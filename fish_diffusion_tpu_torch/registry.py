"""Type-keyed registries: the config→object factory layer.

Equivalent capability to the reference's mmengine registries
(``fish_diffusion/modules/encoders/builder.py:3`` etc.) without the mmengine
dependency: a registry maps a ``type`` string to a callable; ``build`` pops
``type`` from a config dict and calls the target with the remaining kwargs.

A copy of ``fish_diffusion_tpu/registry.py`` with the port's own registries,
so that the same config ``type`` names build PyTorch modules.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._registry: Dict[str, Callable] = {}

    def register_module(
        self, name: Optional[str] = None, module: Optional[Callable] = None
    ):
        """Register a class/function, usable as decorator or direct call."""
        if module is not None:
            self._register(name or module.__name__, module)
            return module

        def decorator(cls):
            self._register(name or cls.__name__, cls)
            return cls

        return decorator

    def _register(self, name: str, module: Callable):
        if name in self._registry and self._registry[name] is not module:
            raise KeyError(f"{name!r} already registered in {self.name}")
        self._registry[name] = module

    def get(self, name: str) -> Callable:
        if name not in self._registry:
            raise KeyError(
                f"{name!r} is not registered in {self.name}. "
                f"Available: {sorted(self._registry)}"
            )
        return self._registry[name]

    def __contains__(self, name: str) -> bool:
        return name in self._registry

    def keys(self):
        return self._registry.keys()

    def build(self, cfg: Dict[str, Any], **extra_kwargs):
        """Instantiate from a config dict with a ``type`` key."""
        if not isinstance(cfg, dict) or "type" not in cfg:
            raise TypeError(f"config must be a dict with a 'type' key, got {cfg!r}")
        cfg = dict(cfg)
        cls = self.get(cfg.pop("type"))
        cfg.update(extra_kwargs)
        return cls(**cfg)


# The registry stable, mirroring the reference's families
# (SURVEY.md §1 L1; e.g. reference modules/encoders/builder.py:3).
ENCODERS = Registry("encoders")
DENOISERS = Registry("denoisers")
DIFFUSIONS = Registry("diffusions")
VOCODERS = Registry("vocoders")
FEATURE_EXTRACTORS = Registry("feature_extractors")
PITCH_EXTRACTORS = Registry("pitch_extractors")
ENERGY_EXTRACTORS = Registry("energy_extractors")
DATASETS = Registry("datasets")
LR_SCHEDULERS = Registry("lr_schedulers")
OPTIMIZERS = Registry("optimizers")
ARCHS = Registry("archs")
