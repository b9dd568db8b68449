"""The configuration file's ``model``, ``input``, ``datasets``, ``solver``
and ``test`` trees, read with attribute access (``cfg.model.head.num_channel``)
as the frozen modules of this package read them. Lists become tuples; the
derived sizes that the program's configuration computes are set here from
the same formulas."""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Mapping


def _wrap(value: Any) -> Any:
    if isinstance(value, Mapping):
        return SimpleNamespace(**{k: _wrap(v) for k, v in value.items()})
    if isinstance(value, (list, tuple)):
        return tuple(_wrap(v) for v in value)
    return value


def load(tree: Mapping[str, Any]) -> SimpleNamespace:
    """The configuration tree (the ``config`` object of a file under
    ``configs/``) as nested namespaces, with ``output_width``,
    ``output_height``, ``max_edge_length`` and ``model.head.num_kpts``."""
    cfg = _wrap(tree)
    down = cfg.model.backbone.down_ratio
    cfg.output_width = cfg.input.width_train // down
    cfg.output_height = cfg.input.height_train // down
    cfg.max_edge_length = (cfg.output_width + cfg.output_height) * 2
    cfg.model.head.num_kpts = cfg.model.head.extra_kpts_num + 10
    return cfg
