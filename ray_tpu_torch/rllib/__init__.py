"""RLlib on the port (the port of ray_tpu/rllib/): environments,
connectors, replay buffers, RLModules, the Learner stack with its
optimizer transforms (`optim`), the on-policy and DQN-family algorithms,
and the evolutionary (ES, ARS), continuous-control (SAC, DDPG, TD3,
Ape-X), decentralized (DD-PPO), offline (BC, MARWIL, CQL, CRR, the
Decision Transformer), bandit, multi-agent (QMIX, MADDPG) and recurrent
(R2D2) families. Learners run on the card unless asked for the CPU
(`device="cpu"`), DD-PPO's ranks sharing it; rollout workers, replay
actors and environments stay in numpy on the CPU.
Still to come (ROADMAP.md, A.9.2): alpha_zero, slateq, maml, dreamer,
fleet and trainstorm."""

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
from ray_tpu_torch.rllib.es import ES, ESConfig
from ray_tpu_torch.rllib.ars import ARS, ARSConfig
from ray_tpu_torch.rllib.apex import (ApexDDPG, ApexDDPGConfig, ApexDQN,
                                      ApexDQNConfig)
from ray_tpu_torch.rllib.sac import SAC, SACConfig
from ray_tpu_torch.rllib.ddpg import DDPG, DDPGConfig, TD3, TD3Config
from ray_tpu_torch.rllib.offline import (
    BC, BCConfig, CQL, CQLConfig, CRR, CRRConfig, MARWIL, MARWILConfig,
    collect_episodes, read_experiences, write_experiences)
from ray_tpu_torch.rllib.bandit import (BanditLinTS, BanditLinUCB,
                                        LinearBanditEnv)
from ray_tpu_torch.rllib.replay_buffers import (ReplayBuffer,
                                                PrioritizedReplayBuffer)
from ray_tpu_torch.rllib.multi_agent import (
    MultiAgentEnv, QMix, QMixConfig, TwoStepCooperativeEnv,
    policy_mapping_rollout)
from ray_tpu_torch.rllib.r2d2 import MemoryCorridorEnv, R2D2, R2D2Config
from ray_tpu_torch.rllib.ddppo import DDPPO, DDPPOConfig
from ray_tpu_torch.rllib.dt import DT, DTConfig
from ray_tpu_torch.rllib.maddpg import MADDPG, MADDPGConfig, SpreadEnv
