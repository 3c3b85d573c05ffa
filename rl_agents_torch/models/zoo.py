"""Model zoo: MLP, dueling, convolutional and entity-attention Q-networks.

Port of ``rl_agents_tpu/models/zoo.py`` (reference:
rl_agents/agents/common/models.py:50-441) as ``torch.nn`` modules, built from
the same config dicts (``size_model_config`` + ``model_factory``).

Each submodule carries the name flax gives it (``Dense_0``, ``base``,
``attention_layer/query_ego``, ``Conv_0``, ...), so that
``convert.flax_params_to_torch`` carries a JAX parameter tree across by name.
flax infers a layer's input width at its first call; here ``model_factory``
takes the observation shape and works each width out up front.

Attention is written as explicit products and a softmax, in the JAX order
(scale by ``1/sqrt(d_k)``, masked scores set to -1e9, softmax), and returns
its attention matrix. With ``dtype="bfloat16"`` the parameters stay float32
and every layer computes in bfloat16, as flax does. Convolutions run under
``torch.backends.cudnn.flags(allow_tf32=False)`` so that cuDNN keeps float32
on the card; the global flags are left alone.
"""
from __future__ import annotations

import logging
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

logger = logging.getLogger(__name__)


def activation_factory(activation_type: str) -> Callable:
    if activation_type == "RELU":
        return F.relu
    elif activation_type == "TANH":
        return torch.tanh
    elif activation_type == "GELU":
        # flax.linen.gelu is the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"Unknown activation_type: {activation_type}")


class Dense(nn.Linear):
    """``flax.linen.Dense``: xavier-uniform kernel, zero bias, float32
    parameters, computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype
        nn.init.xavier_uniform_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class Conv(nn.Conv2d):
    """``flax.linen.Conv`` with a 2x2 kernel, stride 2 and VALID padding."""

    def __init__(self, in_channels: int, out_channels: int, dtype=torch.float32):
        super().__init__(in_channels, out_channels, kernel_size=2, stride=2, padding=0)
        self.dtype = dtype
        nn.init.xavier_uniform_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                        allow_tf32=False):
            return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                            self.bias.to(self.dtype), stride=2)


class MultiLayerPerceptron(nn.Module):
    """(reference: models.py:50-76) ``in_features`` is the width of the last
    axis, or of the flattened input when ``reshape``."""

    def __init__(self, in_features: int, layers: Sequence[int] = (64, 64),
                 activation: str = "RELU", reshape: bool = True, out: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.reshape = reshape
        self.activation = activation_factory(activation)
        widths = [in_features] + list(layers) + ([out] if out else [])
        self.n_hidden = len(layers)
        for i in range(len(widths) - 1):
            self.add_module(f"Dense_{i}", Dense(widths[i], widths[i + 1], dtype=dtype))
        self.out_features = widths[-1]

    def forward(self, x):
        if self.reshape:
            x = x.reshape(x.shape[0], -1)
        for i, layer in enumerate(self.children()):
            x = layer(x)
            if i < self.n_hidden:
                x = self.activation(x)
        return x


class DuelingNetwork(nn.Module):
    """(reference: models.py:79-104) Q = V + A - mean(A)."""

    def __init__(self, in_features: int, out: int = 2, base_layers: Sequence[int] = (64, 64),
                 value_layers: Sequence[int] = (), advantage_layers: Sequence[int] = (),
                 activation: str = "RELU", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.base = MultiLayerPerceptron(in_features, base_layers, activation, dtype=dtype)
        width = self.base.out_features
        self.value = MultiLayerPerceptron(width, value_layers, activation, out=1, dtype=dtype)
        self.advantage = MultiLayerPerceptron(width, advantage_layers, activation, out=out,
                                              dtype=dtype)

    def forward(self, x):
        base = self.base(x)
        value, advantage = self.value(base), self.advantage(base)
        return value + advantage - advantage.mean(dim=1, keepdim=True)


class ConvolutionalNetwork(nn.Module):
    """Three stride-2 convs + MLP head (reference: models.py:107-154). Input
    NCHW; the feature map is flattened in NHWC order into the head, as the
    JAX package lays it out."""

    def __init__(self, in_shape: Tuple[int, int, int], out: int = 2,
                 head_layers: Sequence[int] = (), activation: str = "RELU",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.activation = activation_factory(activation)
        channels, height, width = in_shape
        for i, features in enumerate((16, 32, 64)):
            self.add_module(f"Conv_{i}", Conv(channels, features, dtype=dtype))
            channels, height, width = features, height // 2, width // 2
        self.head = MultiLayerPerceptron(channels * height * width, head_layers, activation,
                                         out=out, dtype=dtype)

    def forward(self, x):
        for conv in (self.Conv_0, self.Conv_1, self.Conv_2):
            x = self.activation(conv(x))
        return self.head(x.permute(0, 2, 3, 1))


def attention(query, key, value, mask=None):
    """Scaled dot-product attention (reference: models.py:370-388).

    query: [B, H, Nq, F], key/value: [B, H, N, F], mask: [B, H, Nq(or 1), N]
    where True marks *masked-out* (absent) entities, as in the reference.
    """
    d_k = query.shape[-1]
    # sqrt(d_k) rounded to the query's dtype, as JAX takes it; host scalars
    # keep the forward free of host-to-device copies (CUDA-graph safe)
    scale = float(torch.tensor(np.sqrt(d_k), dtype=query.dtype, device="cpu"))
    scores = torch.matmul(query, key.transpose(-1, -2)) / scale
    if mask is not None:
        scores = scores.masked_fill(mask, -1e9)
    p_attn = torch.softmax(scores, dim=-1)
    output = torch.matmul(p_attn, value)
    return output, p_attn


class EgoAttention(nn.Module):
    """(reference: models.py:157-194)"""

    def __init__(self, feature_size: int = 64, heads: int = 4, dtype=torch.float32):
        super().__init__()
        self.feature_size, self.heads = feature_size, heads
        for name in ("key_all", "value_all", "query_ego", "attention_combine"):
            self.add_module(name, Dense(feature_size, feature_size, bias=False, dtype=dtype))

    def forward(self, ego, others, mask=None):
        B = others.shape[0]
        F_, H = self.feature_size, self.heads
        fph = F_ // H
        input_all = torch.cat([ego.reshape(B, 1, F_).to(others.dtype), others], dim=1)
        n_entities = input_all.shape[1]
        key_all = self.key_all(input_all).reshape(B, n_entities, H, fph).transpose(1, 2)
        value_all = self.value_all(input_all).reshape(B, n_entities, H, fph).transpose(1, 2)
        query_ego = self.query_ego(ego.reshape(B, 1, F_)).reshape(B, 1, H, fph).transpose(1, 2)
        if mask is not None:
            mask = mask.reshape(B, 1, 1, n_entities)
        value, attention_matrix = attention(query_ego, key_all, value_all, mask)
        combined = self.attention_combine(value.transpose(1, 2).reshape(B, F_))
        result = (combined + ego.reshape(B, F_)) / 2
        return result, attention_matrix


class SelfAttention(nn.Module):
    """(reference: models.py:197-234)"""

    def __init__(self, feature_size: int = 64, heads: int = 4, dtype=torch.float32):
        super().__init__()
        self.feature_size, self.heads = feature_size, heads
        for name in ("key_all", "value_all", "query_all", "attention_combine"):
            self.add_module(name, Dense(feature_size, feature_size, bias=False, dtype=dtype))

    def forward(self, ego, others, mask=None):
        B = others.shape[0]
        F_, H = self.feature_size, self.heads
        fph = F_ // H
        input_all = torch.cat([ego.reshape(B, 1, F_).to(others.dtype), others], dim=1)
        n_entities = input_all.shape[1]

        def heads(layer):
            return layer(input_all).reshape(B, n_entities, H, fph).transpose(1, 2)

        key_all, value_all, query_all = heads(self.key_all), heads(self.value_all), \
            heads(self.query_all)
        if mask is not None:
            mask = mask.reshape(B, 1, 1, n_entities)
        value, attention_matrix = attention(query_all, key_all, value_all, mask)
        combined = self.attention_combine(value.transpose(1, 2).reshape(B, n_entities, F_))
        result = (combined + input_all) / 2
        return result, attention_matrix


class EgoAttentionNetwork(nn.Module):
    """Entity embedding + ego attention + output head (reference: models.py:237-312).
    ``in_features`` is the number of features of an entity."""

    def __init__(self, in_features: int, out: int = 2, presence_feature_idx: int = 0,
                 embedding_layers: Sequence[int] = (128, 128, 128),
                 others_embedding_layers: Sequence[int] = (128, 128, 128),
                 output_layers: Sequence[int] = (128, 128, 128),
                 feature_size: int = 128, heads: int = 4, use_self_attention: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.presence_feature_idx = presence_feature_idx
        self.use_self_attention = use_self_attention
        self.ego_embedding = MultiLayerPerceptron(in_features, embedding_layers, reshape=False,
                                                  dtype=dtype)
        self.others_embedding = MultiLayerPerceptron(in_features, others_embedding_layers,
                                                     reshape=False, dtype=dtype)
        if use_self_attention:
            self.self_attention_layer = SelfAttention(feature_size, heads, dtype=dtype)
        self.attention_layer = EgoAttention(feature_size, heads, dtype=dtype)
        self.output_layer = MultiLayerPerceptron(feature_size, output_layers, out=out,
                                                 reshape=False, dtype=dtype)

    def split_input(self, x, mask=None):
        ego = x[:, 0:1, :]
        others = x[:, 1:, :]
        if mask is None:
            mask = x[:, :, self.presence_feature_idx] < 0.5  # [B, entities]
        return ego, others, mask

    def forward_attention(self, x):
        ego, others, mask = self.split_input(x)
        ego, others = self.ego_embedding(ego), self.others_embedding(others)
        if self.use_self_attention:
            self_att, _ = self.self_attention_layer(ego, others, mask)
            ego, others = self_att[:, 0:1, :], self_att[:, 1:, :]
        return self.attention_layer(ego, others, mask)

    def forward(self, x):
        ego_embedded_att, _ = self.forward_attention(x)
        return self.output_layer(ego_embedded_att)

    def get_attention_matrix(self, x):
        _, attention_matrix = self.forward_attention(x)
        return attention_matrix


class AttentionNetwork(nn.Module):
    """Self-attention over all entities, ego output head (reference: models.py:315-367)."""

    def __init__(self, in_features: int, out: int = 2, presence_feature_idx: int = 0,
                 embedding_layers: Sequence[int] = (128, 128, 128),
                 output_layers: Sequence[int] = (128, 128, 128),
                 feature_size: int = 128, heads: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.presence_feature_idx = presence_feature_idx
        self.embedding = MultiLayerPerceptron(in_features, embedding_layers, reshape=False,
                                              dtype=dtype)
        self.SelfAttention_0 = SelfAttention(feature_size, heads, dtype=dtype)
        self.output = MultiLayerPerceptron(feature_size, output_layers, out=out, reshape=False,
                                           dtype=dtype)

    def forward(self, x):
        mask = x[:, :, self.presence_feature_idx] < 0.5
        embedded = self.embedding(x)
        att, _ = self.SelfAttention_0(embedded[:, 0:1, :], embedded[:, 1:, :], mask)
        return self.output(att[:, 0, :])


def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw ``model``'s parameters afresh from ``generator`` (xavier-uniform
    kernels, zero biases, as flax initialises them); returns the model."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (Dense, Conv)):
                nn.init.xavier_uniform_(module.weight, generator=generator)
                if module.bias is not None:
                    module.bias.zero_()
    return model


def trainable_parameters(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def _space_shape(space):
    if hasattr(space, "spaces"):  # multi-agent tuple: one agent's view
        space = space.spaces[0]
    return tuple(space.shape) if getattr(space, "shape", None) else (1,)


def size_model_config(env, model_config: dict):
    """Fill in/out sizes from env spaces (reference: models.py:404-428)."""
    obs_shape = _space_shape(env.observation_space)
    if model_config.get("type") == "ConvolutionalNetwork":
        model_config["in_channels"] = int(obs_shape[0])
        model_config["in_height"] = int(obs_shape[1])
        model_config["in_width"] = int(obs_shape[2])
    else:
        model_config.setdefault("in", int(np.prod(obs_shape)))
    action_space = env.action_space
    if hasattr(action_space, "spaces"):  # multi-agent: one agent's action set
        action_space = action_space.spaces[0]
    if hasattr(action_space, "n"):
        model_config.setdefault("out", int(action_space.n))


def _layers(config, key, default):
    return tuple(config.get(key, default))


def model_factory(config: dict, obs_shape: Sequence[int]) -> nn.Module:
    """Config-dict driven construction (reference: models.py:431-441) for
    observations of shape ``obs_shape`` (without the batch axis): each layer's
    input width follows from it. The config's own ``"in"`` is the flattened
    size that ``size_model_config`` writes, and is not read here."""
    obs_shape = tuple(int(s) for s in obs_shape) or (1,)
    flat = int(np.prod(obs_shape))
    mtype = config.get("type", "MultiLayerPerceptron")
    dtype = torch.bfloat16 if config.get("dtype") == "bfloat16" else torch.float32
    if mtype == "MultiLayerPerceptron":
        reshape = bool(config.get("reshape", True))
        return MultiLayerPerceptron(
            flat if reshape else obs_shape[-1],
            layers=_layers(config, "layers", (64, 64)),
            activation=config.get("activation", "RELU"),
            reshape=reshape, out=config.get("out"), dtype=dtype)
    elif mtype == "DuelingNetwork":
        base = config.get("base_module", {})
        return DuelingNetwork(
            flat, out=config["out"],
            base_layers=_layers(base, "layers", (64, 64)),
            value_layers=_layers(config.get("value", {}), "layers", ()),
            advantage_layers=_layers(config.get("advantage", {}), "layers", ()),
            activation=config.get("activation", "RELU"), dtype=dtype)
    elif mtype == "ConvolutionalNetwork":
        return ConvolutionalNetwork(
            obs_shape, out=config["out"],
            head_layers=_layers(config.get("head_mlp", {}), "layers", ()),
            activation=config.get("activation", "RELU"), dtype=dtype)
    elif mtype == "EgoAttentionNetwork":
        att = config.get("attention_layer", {})
        emb = _layers(config.get("embedding_layer", {}), "layers", (128, 128, 128))
        # when unspecified, the others' embedding takes the ego embedding's
        # widths: the attention concatenates the two (see the JAX package's
        # model_factory and docs/migration.md "EgoAttention embedding defaults")
        others = _layers(config.get("others_embedding_layer", {}), "layers", emb)
        if "others_embedding_layer" not in config and others != (128, 128, 128):
            logger.warning(
                "EgoAttentionNetwork: others_embedding defaults to the ego "
                "embedding widths %s (reference default is (128, 128, 128), "
                "which cannot feed a feature_size-%s attention); set "
                "others_embedding_layer explicitly to silence this.",
                others, att.get("feature_size", 128))
        return EgoAttentionNetwork(
            obs_shape[-1], out=config["out"],
            presence_feature_idx=config.get("presence_feature_idx", 0),
            embedding_layers=emb,
            others_embedding_layers=others,
            output_layers=_layers(config.get("output_layer", {}), "layers", (128, 128, 128)),
            feature_size=att.get("feature_size", 128),
            heads=att.get("heads", 4),
            use_self_attention=bool(config.get("self_attention_layer")), dtype=dtype)
    elif mtype == "AttentionNetwork":
        att = config.get("attention_layer", {})
        return AttentionNetwork(
            obs_shape[-1], out=config["out"],
            presence_feature_idx=config.get("presence_feature_idx", 0),
            embedding_layers=_layers(config.get("embedding_layer", {}), "layers", (128, 128, 128)),
            output_layers=_layers(config.get("output_layer", {}), "layers", (128, 128, 128)),
            feature_size=att.get("feature_size", 128),
            heads=att.get("heads", 4), dtype=dtype)
    raise ValueError(f"Unknown model type: {mtype}")
