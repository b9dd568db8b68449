"""The program under test, as the harness reaches it: its configuration
built from a configuration tree, and nothing else of it but its entry
points (imported where a loop uses them), its launch counters and the
names of its kernels."""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping


def _to_field(current: Any, value: Any) -> Any:
    if dataclasses.is_dataclass(current):
        return _replace(current, value)
    if isinstance(value, list):
        return tuple(_to_field(None, v) for v in value)
    return value


def _replace(dc: Any, tree: Mapping[str, Any]) -> Any:
    names = {f.name for f in dataclasses.fields(dc)}
    unknown = set(tree) - names
    if unknown:
        raise KeyError(f"{type(dc).__name__} has no field {sorted(unknown)}")
    return dataclasses.replace(dc, **{k: _to_field(getattr(dc, k), v) for k, v in tree.items()})


def _plain(x: Any) -> Any:
    if isinstance(x, Mapping):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def program_config(tree: Mapping[str, Any]):
    """The program's ``Config`` holding every number of ``tree``; raises
    where the tree names a key the program does not have or leaves one out
    (the configuration file is the configuration as it is run)."""
    from dcd_tpu_torch.config import Config

    cfg = _replace(Config(), tree)
    got = _plain(dataclasses.asdict(cfg))
    if got != _plain(tree):
        missing = sorted(set(got) ^ set(_plain(tree)))
        raise ValueError(f"the configuration tree is not the program's whole configuration "
                         f"(top-level keys apart: {missing})")
    return cfg
