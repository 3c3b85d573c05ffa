from rl_agents_torch.envs.base import (
    Box,
    Discrete,
    EnvHandle,
    EnvSpec,
    FunctionalEnv,
    StepOut,
    policy_rollout,
    vector_reset,
    vector_step,
)

__all__ = [
    "Box",
    "Discrete",
    "EnvHandle",
    "EnvSpec",
    "FunctionalEnv",
    "StepOut",
    "policy_rollout",
    "vector_reset",
    "vector_step",
]
