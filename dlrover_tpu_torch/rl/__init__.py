"""RLHF engine (counterpart of ``dlrover_tpu/rl/``; parity:
atorch/atorch/rl/ — model engine, PPO trainer, replay buffer, generation
backend).

Generation is the training model's own forward over a static KV cache
written in place (``models/transformer.forward_step``), the rollouts'
scoring and the PPO / Bradley–Terry updates go through ``forward`` and so
through the flash attention kernels on the card. The reward model is
trainable from preference pairs (``rl/reward.py``) behind the same
``reward_fn`` seam a programmatic reward uses. Rollout under a mesh and
the hybrid train / rollout placement raise ``NotImplementedError``
(ROADMAP A14b).
"""

from dlrover_tpu_torch.rl.generation import generate  # noqa: F401
from dlrover_tpu_torch.rl.buffer import ReplayBuffer  # noqa: F401
from dlrover_tpu_torch.rl.ppo import PPOConfig, RLHFEngine  # noqa: F401
from dlrover_tpu_torch.rl.reward import RewardModel  # noqa: F401
