"""Config: an attribute-access dict, counterpart of targetdiff_tpu/config.py.

`load_config` imports yaml inside the function, so the sampling path (which
builds its Config from a dict or a checkpoint's metadata) never needs PyYAML.
"""

from __future__ import annotations

import io
import os
from typing import Any, Mapping


class Config(dict):
    """Nested dict with attribute access."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for k, v in dict(*args, **kwargs).items():
            self[k] = _wrap(v)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)


def _wrap(v: Any) -> Any:
    if isinstance(v, Config):
        return v
    if isinstance(v, Mapping):
        return Config(v)
    if isinstance(v, (list, tuple)):
        return type(v)(_wrap(x) for x in v)
    return v


def load_config(path_or_stream) -> Config:
    """YAML file, stream or text -> Config."""
    import yaml

    if isinstance(path_or_stream, (str, os.PathLike)):
        with open(path_or_stream, "r") as f:
            raw = yaml.safe_load(f)
    elif isinstance(path_or_stream, io.IOBase):
        raw = yaml.safe_load(path_or_stream)
    else:
        raw = yaml.safe_load(str(path_or_stream))
    return Config(raw or {})
