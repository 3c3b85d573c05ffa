"""Port of rl_agents_tpu/models: the Q-network zoo and the optimizers."""
from rl_agents_torch.models.zoo import (
    AttentionNetwork,
    ConvolutionalNetwork,
    DuelingNetwork,
    EgoAttention,
    EgoAttentionNetwork,
    MultiLayerPerceptron,
    SelfAttention,
    activation_factory,
    attention,
    model_factory,
    size_model_config,
    trainable_parameters,
)

__all__ = [
    "AttentionNetwork",
    "ConvolutionalNetwork",
    "DuelingNetwork",
    "EgoAttention",
    "EgoAttentionNetwork",
    "MultiLayerPerceptron",
    "SelfAttention",
    "activation_factory",
    "attention",
    "model_factory",
    "size_model_config",
    "trainable_parameters",
]
