"""Connectors: composable pre/post-processing between env and module.

Reference: `rllib/connectors/connector.py` (`Connector`, `ConnectorPipeline`)
— small, stateful-if-needed transforms chained into pipelines that sit on
the two seams of an EnvRunner: observations flowing env -> module, and
actions flowing module -> env. Keeping them outside the module keeps the
policy forward pure; connectors run host-side numpy per step.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np


class Connector:
    """One transform. `__call__(data)` returns the transformed array; state()
    / set_state() carry whatever the transform accumulates (e.g. running
    normalization moments) through checkpoints and across weight syncs."""

    def __call__(self, data: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def state(self) -> Dict[str, Any]:
        return {}

    def set_state(self, state: Dict[str, Any]) -> None:
        pass

    def __repr__(self):
        return type(self).__name__


class ConnectorPipeline(Connector):
    """Apply connectors in order (reference: `ConnectorPipeline`)."""

    def __init__(self, *connectors: Connector):
        self.connectors: List[Connector] = list(connectors)

    def append(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.append(connector)
        return self

    def prepend(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.insert(0, connector)
        return self

    def __call__(self, data: np.ndarray) -> np.ndarray:
        for c in self.connectors:
            data = c(data)
        return data

    def state(self) -> Dict[str, Any]:
        return {str(i): c.state() for i, c in enumerate(self.connectors)}

    def set_state(self, state: Dict[str, Any]) -> None:
        for i, c in enumerate(self.connectors):
            if str(i) in state:
                c.set_state(state[str(i)])

    def __repr__(self):
        return f"ConnectorPipeline({', '.join(map(repr, self.connectors))})"


def build_connector(spec) -> Connector:
    """Normalize a config value into a Connector: an instance passes through,
    a callable is invoked (factory), a list/tuple becomes a pipeline."""
    if spec is None:
        return None
    if isinstance(spec, Connector):
        return spec
    if isinstance(spec, (list, tuple)):
        return ConnectorPipeline(*[build_connector(s) for s in spec])
    if callable(spec):
        return build_connector(spec())
    raise TypeError(f"cannot build a connector from {spec!r}")
