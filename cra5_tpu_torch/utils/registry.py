"""Plain-dict registries with decorator registration.

The port's own copy of ``cra5_tpu/utils/registry.py``: ``Registry`` with
``register``, ``get``, ``build``, membership and ``keys``, and the five
registries ``MODELS``, ``DATASETS``, ``CRITERIONS``, ``OPTIMIZERS`` and
``SCHEDULERS``, which ``cra5_tpu_torch/registry.py`` fills (the schedules
register themselves in ``train/schedulers.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._items: Dict[str, Any] = {}

    def register(self, name: Optional[str] = None) -> Callable:
        def deco(obj):
            key = name or obj.__name__
            if key in self._items:
                raise KeyError(f"{key!r} already registered in {self.name}")
            self._items[key] = obj
            return obj

        return deco

    def get(self, name: str) -> Any:
        if name not in self._items:
            raise KeyError(f"{name!r} not found in registry {self.name!r} "
                           f"(available: {sorted(self._items)})")
        return self._items[name]

    def build(self, cfg: dict, **extra) -> Any:
        cfg = dict(cfg)
        kind = cfg.pop("type")
        return self.get(kind)(**cfg, **extra)

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def keys(self):
        return self._items.keys()


MODELS = Registry("models")
DATASETS = Registry("datasets")
CRITERIONS = Registry("criterions")
OPTIMIZERS = Registry("optimizers")
SCHEDULERS = Registry("schedulers")
