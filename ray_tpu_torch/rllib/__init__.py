"""RLlib on the port (the port of ray_tpu/rllib/): environments,
connectors, replay buffers, RLModules, the Learner stack with its
optimizer transforms (`optim`), and the on-policy and DQN-family
algorithms. Learners run on the card unless asked for the CPU
(`device="cpu"`); rollout workers act in numpy on the CPU. The other
algorithms of the reference are not ported yet (ROADMAP.md, A.9.2)."""

from ray_tpu_torch.rllib.env import (
    CartPoleEnv, ContinuousVectorEnv, PendulumEnv, VectorEnv)
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.learner import Learner, LearnerGroup, delayed
from ray_tpu_torch.rllib.rl_module import (
    Categorical, Deterministic, DeterministicPolicyModule,
    DiscreteActorCriticModule, QModule, RecurrentQModule, RLModule,
    SquashedGaussian, SquashedGaussianModule)
from ray_tpu_torch.rllib.connectors import (
    ArgmaxAction, CastObsFloat32, ClipAction, Connector, ConnectorPipeline,
    EpsilonGreedy, GaussianNoise, RandomActions, SampleAction)
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.a2c import A2C, A2CConfig
from ray_tpu_torch.rllib.a3c import A3C, A3CConfig
from ray_tpu_torch.rllib.pg import PG, PGConfig
from ray_tpu_torch.rllib.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.simple_q import SimpleQ, SimpleQConfig
from ray_tpu_torch.rllib.random_agent import RandomAgent, RandomAgentConfig
from ray_tpu_torch.rllib.impala import IMPALA, ImpalaConfig
from ray_tpu_torch.rllib.replay_buffers import (ReplayBuffer,
                                                PrioritizedReplayBuffer)
