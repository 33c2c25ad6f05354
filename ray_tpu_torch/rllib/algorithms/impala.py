"""IMPALA: importance-weighted actor-learner architecture with V-trace.

The counterpart of ``ray_tpu/rllib/algorithms/impala.py``; reference:
`rllib/algorithms/impala/impala.py` (ImpalaConfig: `vtrace=True,
vtrace_clip_rho_threshold=1.0, vtrace_clip_pg_rho_threshold=1.0,
entropy_coeff=0.01, vf_loss_coeff=0.5, grad_clip=40`) and the V-trace math in
`rllib/algorithms/impala/vtrace_torch.py` (Espeholt et al. 2018, eq. 1):
vs_t = V(x_t) + sum_k gamma^k (prod c) rho_k delta_k, computed as a reverse
recursion; policy gradient uses rho_t (r_t + gamma vs_{t+1} - V(x_t)).

The whole V-trace computation lives inside the loss, on the learner's
device: batches keep their env-major (N, T) structure, and the recursion is a
reverse loop over T (the JAX package's `lax.scan`), one fused multiply-add
per step. There is no GAE pass on the host: the correction IS the target
computation. Truncated (time-limit) episodes bootstrap through V(final_obs)
evaluated with the CURRENT parameters inside the loss, not the stale
behavior-policy value the runner saw.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.a2c import categorical_terms, sample_rollouts, timed_update
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import adam


class ImpalaConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 5e-4
        self.vtrace_clip_rho_threshold = 1.0
        self.vtrace_clip_pg_rho_threshold = 1.0
        self.vtrace_clip_c_threshold = 1.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.grad_clip = 40.0
        self._algo_cls = Impala


def _next_values(later, last_values, fin_values, batch):
    """V(x_{t+1}) per (N, T) row with episode boundaries: ``later`` shifted
    one step, V(last_obs) at the tail, V(final_obs) at a truncation, 0 at a
    termination."""
    nxt = torch.cat([later[:, 1:], last_values[:, None]], dim=1)
    nxt = torch.where(batch["truncateds"] > 0, fin_values, nxt)
    return nxt * (1.0 - batch["terminateds"])


def vtrace(module, params, batch, target_logp, values, gamma, rho_bar, pg_rho_bar, c_bar):
    """V-trace targets and policy-gradient advantages over an env-major (N, T)
    batch, with no gradient (the JAX loss stops both): (vs, pg_adv, rho).
    ``target_logp`` is log pi(a|s) of the policy V-trace corrects toward."""
    with torch.no_grad():
        _, last_values = module.forward(params, batch["last_obs"])  # (N,)
        # V(final_obs) under CURRENT params for time-limit bootstraps; rows
        # without truncation hold zeros in final_obs and their value is unused.
        _, fin_values = module.forward(params, batch["final_obs"])  # (N, T)
        values = values.detach()
        rho = torch.exp(target_logp.detach() - batch["logp"])
        clipped_rho = torch.clamp(rho, max=rho_bar)
        c = torch.clamp(rho, max=c_bar)
        delta = clipped_rho * (batch["rewards"]
                               + gamma * _next_values(values, last_values, fin_values, batch)
                               - values)
        # Reverse recursion over T: acc carries (vs_{t+1} - V(x_{t+1})); the
        # dones (truncations included) cut it, so the correction never leaks
        # across resets.
        coef = gamma * c * (1.0 - batch["dones"])
        acc = torch.zeros_like(values[:, 0])
        steps = []
        for t in reversed(range(values.shape[1])):
            acc = torch.addcmul(delta[:, t], coef[:, t], acc)
            steps.append(acc)
        vs = torch.stack(steps[::-1], dim=1) + values
        vs_next = _next_values(vs, last_values, fin_values, batch)
        pg_adv = torch.clamp(rho, max=pg_rho_bar) * (batch["rewards"] + gamma * vs_next - values)
    return vs, pg_adv, rho


def make_impala_loss(config: ImpalaConfig) -> Callable:
    """(module, params, batch) -> (loss, aux). Batch arrays are (N, T, ...),
    env-major, so the leading axis is the one a learner gang splits."""
    gamma = config.gamma
    rho_bar = config.vtrace_clip_rho_threshold
    pg_rho_bar = config.vtrace_clip_pg_rho_threshold
    c_bar = config.vtrace_clip_c_threshold
    vf_coeff = config.vf_loss_coeff
    ent_coeff = config.entropy_coeff

    def loss(module, params, batch):
        target_logp, entropy, values, _ = categorical_terms(
            module, params, batch["obs"], batch["actions"])
        vs, pg_adv, rho = vtrace(module, params, batch, target_logp, values, gamma, rho_bar,
                                 pg_rho_bar, c_bar)
        pi_loss = -torch.mean(target_logp * pg_adv)
        vf_loss = 0.5 * torch.mean(torch.square(values - vs))
        total = pi_loss + vf_coeff * vf_loss - ent_coeff * entropy
        aux = {
            "policy_loss": pi_loss,
            "vf_loss": vf_loss,
            "entropy": entropy,
            "mean_rho": torch.mean(rho),
        }
        return total, aux

    return loss


class Impala(Algorithm):
    # The loss recomputes values/bootstraps under CURRENT params (V-trace):
    # runner-side value evaluations and dist buffers would be dead weight.
    _record_value_extras = False

    def make_loss(self) -> Callable:
        return make_impala_loss(self.config)

    def make_optimizer(self):
        return adam(self.config.lr, grad_clip=self.config.grad_clip)

    # ----------------------------------------------------------- one iteration
    def _sample_env_major_batch(self):
        """Sync weights, gather rollouts, and assemble the (N, T, ...)
        env-major batch the V-trace losses consume — concat over runners on
        the env axis (the axis a LearnerGroup splits). Shared by IMPALA and
        APPO: (batch, sample seconds)."""
        rollouts, sample_s = sample_rollouts(self)

        def env_major(key):
            return np.concatenate(
                [np.moveaxis(ro[key], 0, 1) for ro in rollouts], axis=0
            )

        batch = {
            k: env_major(k)
            for k in (
                "obs", "actions", "logp", "rewards",
                "dones", "terminateds", "truncateds", "final_obs",
            )
        }
        batch["last_obs"] = np.concatenate([ro["last_obs"] for ro in rollouts], axis=0)
        return batch, sample_s

    def training_step(self) -> Dict[str, Any]:
        batch, sample_s = self._sample_env_major_batch()
        out = timed_update(self, batch, {"sample_time_s": sample_s})
        out["num_env_steps_sampled"] = int(batch["rewards"].size)
        return self.collect_episode_metrics(out)


IMPALA = Impala
IMPALAConfig = ImpalaConfig
