"""ModelCatalog: config-driven module construction.

Reference: `rllib/models/catalog.py:197` (`ModelCatalog.get_model_v2` — the
registry that turns a `model` config dict into a network for the algorithm's
needs). Here the catalog maps `config.model` onto the RLModule zoo:
`kind` names what the algorithm needs (policy+value, Q-net, squashed
Gaussian, deterministic continuous), the model dict supplies architecture
(`hiddens`/`fcnet_hiddens`, `activation`/`fcnet_activation`, `custom_module`).
Custom architectures plug in via `register_custom_module` + `custom_module`,
mirroring the reference's `ModelCatalog.register_custom_model`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

MODEL_DEFAULTS: Dict[str, Any] = {
    # Reference names (fcnet_*) and repo-native names are both accepted.
    "hiddens": (64, 64),
    "activation": "tanh",
    "custom_module": None,
    "custom_module_config": {},
}

_CUSTOM_MODULES: Dict[str, Callable] = {}


def register_custom_module(name: str, factory: Callable) -> None:
    """Register a module factory invoked as
    `factory(obs_dim, action_space, model_config)` when `config.model`
    contains `custom_module: name` (reference:
    `ModelCatalog.register_custom_model`)."""
    _CUSTOM_MODULES[name] = factory


def _hiddens(model_config: Dict[str, Any], default=(64, 64)):
    h = model_config.get("hiddens", model_config.get("fcnet_hiddens", default))
    return tuple(int(x) for x in h)


def _activation(model_config: Dict[str, Any]) -> str:
    return str(
        model_config.get(
            "activation", model_config.get("fcnet_activation", "tanh")
        )
    )


class ModelCatalog:
    """Stateless factory; all construction rides classmethods like the
    reference's."""

    @staticmethod
    def get_module(
        kind: str,
        obs_dim: int,
        action_space: Any,
        model_config: Dict[str, Any],
    ):
        """Build the RLModule for `kind`:

        - "pi_vf": policy + value towers over Discrete actions
        - "q": Q-network over Discrete actions
        - "squashed_gaussian": SAC-style stochastic continuous actor-critic
        - "deterministic_continuous": TD3/DDPG-style deterministic actor +
          twin critics

        `action_space` is a space with `n` (Discrete) or `low`/`high` (Box);
        `model_config` is the algorithm's `config.model` dict.
        """
        from ray_tpu_torch.rllib.core import rl_module as m

        custom = model_config.get("custom_module")
        if custom:
            if custom not in _CUSTOM_MODULES:
                raise ValueError(
                    f"custom_module {custom!r} is not registered "
                    "(register_custom_module first)"
                )
            return _CUSTOM_MODULES[custom](obs_dim, action_space, model_config)

        act = _activation(model_config)
        if kind == "pi_vf":
            return m.MLPModule(
                obs_dim, int(action_space.n),
                hiddens=_hiddens(model_config), activation=act,
            )
        if kind == "q":
            return m.QMLPModule(
                obs_dim, int(action_space.n),
                hiddens=_hiddens(model_config), activation=act,
            )
        if kind == "squashed_gaussian":
            return m.SquashedGaussianModule(
                obs_dim, action_space.low, action_space.high,
                hiddens=_hiddens(model_config, (256, 256)), activation=act,
            )
        if kind == "deterministic_continuous":
            return m.DeterministicContinuousModule(
                obs_dim, action_space.low, action_space.high,
                hiddens=_hiddens(model_config, (256, 256)), activation=act,
            )
        raise ValueError(f"unknown module kind {kind!r}")
