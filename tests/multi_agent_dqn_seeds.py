"""Multi-agent DQN by the JAX test's configuration (tests/test_rllib_extras.py:
207-244) at several seeds, in the JAX package or the port, on the CPU: each
seed's curve of summed returns and whether it meets that test's bar (best >
first + 10 within 15 iterations). The bar on one seed is a coin toss in both
packages; chip_smoke.py's rl_multi_agent phase holds the mean curve of
MA_DQN_SEEDS instead.

    JAX_PLATFORMS=cpu python tests/multi_agent_dqn_seeds.py jax 0 1 2
    python tests/multi_agent_dqn_seeds.py torch 0 1 2
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(package, seeds):
    if package == "jax":
        import ray_tpu as rt
        from ray_tpu.rllib import DQNConfig, make_multi_agent

        env = "CartPole-v1"
    else:
        import chip_smoke
        import ray_tpu_torch as rt
        from ray_tpu_torch.rllib import DQNConfig, make_multi_agent

        env = chip_smoke.CartPole
    creator = make_multi_agent(env)
    rt.init(num_cpus=4)
    try:
        for seed in seeds:
            cfg = (DQNConfig().environment(lambda c=None: creator({"num_agents": 2}))
                   .env_runners(num_env_runners=2, num_envs_per_runner=2,
                                rollout_fragment_length=64)
                   .training(lr=1e-3, learning_starts=500, train_batch_size=64,
                             updates_per_iteration=16, epsilon_decay_steps=4000,
                             model={"hiddens": (64, 64)})
                   .multi_agent(policies=["p0", "p1"],
                                policy_mapping_fn=lambda a: "p0" if a == "0" else "p1"))
            cfg.seed = seed
            if package != "jax":
                cfg = cfg.learners(num_gpus_per_learner=0)
            algo = cfg.build()
            try:
                rets = [algo.train().get("episode_return_mean") for _ in range(15)]
            finally:
                algo.stop()
            done = [r for r in rets if r is not None]
            passed = bool(done) and max(done) > done[0] + 10
            print(package, seed, "bar met" if passed else "bar missed",
                  [round(r, 1) for r in done], flush=True)
    finally:
        rt.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], [int(s) for s in sys.argv[2:]] or [0])
