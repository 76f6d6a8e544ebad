"""RLHF with the PyTorch port's PPO engine (the port of
``examples/rlhf_ppo.py``): a reward model TRAINED from preference pairs
(Bradley–Terry), KV-cache rollouts, clipped PPO with GAE. Runs on the
card (the flash attention kernels: bf16, head_dim 64) unless ``--cpu``
is given.

    python examples/rlhf_ppo_torch.py [--cpu] [--iters 10] [--rm-steps 40]

(repo root on ``PYTHONPATH``). The rollouts score sequences of prompt +
completion tokens, 19 and 20 here: lengths that are no multiple of the
kernels' 64-row tile.
"""

import argparse

import numpy as np

from dlrover_tpu_torch.models import tiny
from dlrover_tpu_torch.rl import PPOConfig, RLHFEngine, RewardModel


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU's plain path")
    ap.add_argument("--iters", type=int, default=10, help="PPO iterations")
    ap.add_argument("--rm-steps", type=int, default=40, help="reward model steps")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None  # None: the card
    cfg = tiny(vocab_size=64, num_layers=2, max_seq_len=64, model_dim=128, num_heads=2,
               num_kv_heads=2, mlp_dim=256, dtype="bfloat16")

    # 1) reward model from preference pairs: "chosen" completions favor
    # token 7 (stand-in for human preference data)
    rng = np.random.default_rng(0)
    chosen = rng.choice([7, 9], size=(128, 16), p=[0.9, 0.1]).astype(np.int32)
    rejected = rng.choice([3, 9], size=(128, 16), p=[0.9, 0.1]).astype(np.int32)
    rm = RewardModel(cfg, lr=1e-3, device=device)
    m = {}
    for _ in range(args.rm_steps):
        m = rm.train_on_preferences(chosen, rejected)
    print(f"reward model: acc={m['accuracy']:.2f} loss={m['loss']:.4f}")

    # 2) PPO against the trained reward model (a mesh, train_mesh= /
    # rollout_mesh=, is ROADMAP A14b)
    engine = RLHFEngine(
        cfg,
        rm.as_reward_fn(),
        ppo=PPOConfig(
            rollout_batch=32,
            max_new_tokens=16,
            minibatch_size=32,
            ppo_epochs=2,
            learning_rate=3e-3,
            kl_coef=0.02,
        ),
        device=device,
    )
    prompts = np.zeros((32, 4), dtype=np.int32)
    for it in range(args.iters):
        exp = engine.make_experience(prompts)
        metrics = engine.train(prompt_len=prompts.shape[1])
        print(
            f"iter {it}: reward={exp.rewards[:, -1].mean():.3f} "
            f"kl={metrics['approx_kl']:.4f} loss={metrics['loss']:.4f}"
        )
    return metrics


if __name__ == "__main__":
    main()
