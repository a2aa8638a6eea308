"""YAML config system with attribute access (port of
decompdiff_tpu/config.py; PyYAML is imported only where a file is read or
written, so the package imports without it).

Role parity with ref utils/misc.py:26-28 (YAML -> EasyDict) plus the liberal
getattr-with-default convention used throughout the reference
(e.g. ref models/decompdiff.py:85-90). Checkpoints embed the full config and
sampling re-reads hyperparameters from the checkpoint, so Config must be
round-trippable to plain dicts (ref scripts/sample_diffusion_decomp.py:499-545).
"""

from __future__ import annotations

import copy
import json


class Config(dict):
    """dict with attribute access; nested dicts are wrapped recursively."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        d = dict(d or {}, **kwargs)
        for k, v in d.items():
            self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v):
        if isinstance(v, dict) and not isinstance(v, Config):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return type(v)(cls._wrap(x) for x in v)
        return v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = self._wrap(value)

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def get(self, key, default=None):
        return super().get(key, default)

    @staticmethod
    def _unwrap(v):
        # symmetric with _wrap: recurse through nested lists too, or a
        # Config two list levels down survives into yaml.safe_dump and
        # raises RepresenterError
        if isinstance(v, Config):
            return v.to_dict()
        if isinstance(v, (list, tuple)):
            return [Config._unwrap(x) for x in v]
        return v

    def to_dict(self):
        return {k: self._unwrap(v) for k, v in self.items()}


def load_config(path: str) -> Config:
    """A YAML config, or a JSON one (as the training driver writes a run's
    config.yml), which needs no PyYAML: JSON is read as JSON, since PyYAML
    reads a JSON number such as 1e-07 as a string."""
    with open(path) as f:
        text = f.read()
    try:
        return Config(json.loads(text))
    except json.JSONDecodeError:
        import yaml
        return Config(yaml.safe_load(text))


def save_config(config: Config, path: str) -> None:
    import yaml
    with open(path, 'w') as f:
        yaml.safe_dump(config.to_dict(), f, sort_keys=False)
