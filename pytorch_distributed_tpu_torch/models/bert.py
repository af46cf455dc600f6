"""BERT in PyTorch: the port of ``pytorch_distributed_tpu/models/bert.py``.

The classic post-LN encoder: token, position and token-type embeddings
summed in f32 (the f32 tables' dtype, as flax's ``nn.Embed`` returns it)
then ``embed_ln``; each layer self-attention (no mask but the ``[B, S]``
key-padding ``attention_mask``, through ``ops.attention.attention``: the
flash kernels on the card) then ``attn_ln(x + attn)``, an exact-erf GELU
MLP then ``mlp_ln(x + mlp)``; the pooler is ``tanh`` of a Dense over
``x[:, 0]``. :class:`BertForSequenceClassification` puts a Dense
classifier on the pooled output, :class:`BertForMaskedLM` a transform
(Dense, GELU, LayerNorm) and a decoder tied to the word embeddings plus
a free ``mlm_bias``, with f32 logits.

The dtype policy is GPT-2's (``models/gpt2.py``): parameters in
``policy.param_dtype``, every product in ``policy.compute_dtype`` with
the weight cast at its use, LayerNorm statistics in f32 (eps 1e-12),
outputs in ``policy.output_dtype``. A model built without a policy takes
``runtime.precision.current_policy()`` (what ``autocast`` sets). Dropout
draws its masks from the ``generator`` the caller passes. Module names
follow the JAX tree (``bert.layers.3.attn.query`` is
``bert/layer3/attn/query``); ``interop.bert_slots`` maps each tensor to
its leaf. :func:`bert_partition_rules` places the JAX leaves for tensor
parallelism (a rule table: the BERT recipe's ``--tp`` is ROADMAP A10.1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_tpu_torch.models.gpt2 import (
    _TRUNC_STD,
    Dense,
    LayerNorm,
    dropout,
)
from pytorch_distributed_tpu_torch.ops.attention import attention
from pytorch_distributed_tpu_torch.runtime.device import (
    DeviceLike,
    resolve_device,
)
from pytorch_distributed_tpu_torch.runtime.precision import (
    Policy,
    current_policy,
)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30_522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3_072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    dropout_rate: float = 0.1
    layer_norm_eps: float = 1e-12

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def base(cls) -> "BertConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "BertConfig":  # test/smoke configuration
        return cls(
            vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position_embeddings=128,
        )


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, *, policy: Policy, device):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        kw = dict(policy=policy, device=device)
        self.query = Dense(H, H, **kw)   # out = (heads, head_dim)
        self.key = Dense(H, H, **kw)
        self.value = Dense(H, H, **kw)
        self.out = Dense(H, H, **kw)     # in = (heads, head_dim)

    def forward(self, x, attention_mask, *, train: bool, generator,
                attn_impl: Optional[str] = None):
        cfg = self.cfg
        B, S, H = x.shape
        shape = (B, S, cfg.num_heads, cfg.head_dim)
        q = self.query(x).view(shape)
        k = self.key(x).view(shape)
        v = self.value(x).view(shape)
        out = attention(q, k, v, mask=attention_mask, impl=attn_impl)
        out = self.out(out.reshape(B, S, H))
        return dropout(out, cfg.dropout_rate, train, generator)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, *, policy: Policy, device):
        super().__init__()
        self.cfg = cfg
        H, eps = cfg.hidden_size, cfg.layer_norm_eps
        kw = dict(policy=policy, device=device)
        self.attn = BertSelfAttention(cfg, **kw)
        self.attn_ln = LayerNorm(H, eps, **kw)
        self.mlp_up = Dense(H, cfg.intermediate_size, **kw)
        self.mlp_down = Dense(cfg.intermediate_size, H, **kw)
        self.mlp_ln = LayerNorm(H, eps, **kw)

    def forward(self, x, attention_mask, *, train: bool, generator,
                attn_impl: Optional[str] = None):
        attn = self.attn(x, attention_mask, train=train, generator=generator,
                         attn_impl=attn_impl)
        x = self.attn_ln(x + attn)
        h = F.gelu(self.mlp_up(x), approximate="none")  # BERT's exact erf
        h = dropout(self.mlp_down(h), self.cfg.dropout_rate, train,
                    generator)
        return self.mlp_ln(x + h)


class BertModel(nn.Module):
    """Encoder trunk: ``(sequence_output, pooled_output)`` in the
    policy's output dtype."""

    def __init__(self, config: BertConfig, *, device: DeviceLike = None,
                 policy: Optional[Policy] = None):
        super().__init__()
        device = resolve_device(device)
        policy = policy or current_policy()
        self.config = config
        self.policy = policy
        H = config.hidden_size
        kw = dict(device=device, dtype=policy.param_dtype)
        self.word_embeddings = nn.Embedding(config.vocab_size, H, **kw)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, H, **kw)
        self.token_type_embeddings = nn.Embedding(
            config.type_vocab_size, H, **kw)
        mkw = dict(policy=policy, device=device)
        self.embed_ln = LayerNorm(H, config.layer_norm_eps, **mkw)
        self.layers = nn.ModuleList(
            BertLayer(config, **mkw) for _ in range(config.num_layers))
        self.pooler = Dense(H, H, **mkw)

    def _token_types(self, token_type_ids):
        """The token-type rows as a one-hot sum over the (two-row) table:
        each is exactly its row, and the table's gradient is a sum over
        the positions, the same bits on every run. ``nn.Embedding``'s
        CUDA backward, which scatters every position onto one of the two
        rows, did not repeat to the bit between runs on an H100
        (chip_smoke.py phase 9c)."""
        table = self.token_type_embeddings.weight
        onehot = F.one_hot(token_type_ids.long(), table.shape[0])
        return (onehot.to(table.dtype)[..., None] * table).sum(-2)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None, *,
                train: bool = False, generator=None,
                attn_impl: Optional[str] = None,
                return_embed_table: bool = False):
        cfg, policy = self.config, self.policy
        B, S = input_ids.shape
        if S > cfg.max_position_embeddings:
            raise ValueError(
                f"sequence {S} > max_position_embeddings "
                f"{cfg.max_position_embeddings}")
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if attention_mask is None:
            attention_mask = torch.ones((B, S), dtype=torch.bool,
                                        device=input_ids.device)
        attention_mask = attention_mask.to(torch.bool)
        positions = torch.arange(S, device=input_ids.device)[None, :]
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(positions)
             + self._token_types(token_type_ids))
        x = self.embed_ln(x)
        x = dropout(x, cfg.dropout_rate, train, generator)
        x = x.to(policy.compute_dtype)
        for layer in self.layers:
            x = layer(x, attention_mask, train=train, generator=generator,
                      attn_impl=attn_impl)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        out = (x.to(policy.output_dtype), pooled.to(policy.output_dtype))
        if return_embed_table:
            return out + (self.word_embeddings.weight,)
        return out


@torch.no_grad()
def _init_bert(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded weights drawn as flax's initializers draw them: Dense
    kernels lecun-normal (truncated at 2 std, variance 1/fan_in),
    embeddings normal with variance 1/hidden_size, biases zero (the MLM
    ``mlm_bias`` too), LayerNorm scales one."""
    H = model.bert.config.hidden_size
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)
        if "_embeddings." in name:
            draw = torch.randn(p.shape, generator=generator, device=p.device,
                               dtype=torch.float32)
            p.copy_(draw / math.sqrt(H))
        elif leaf[0].endswith("_ln"):
            p.fill_(1.0 if leaf[-1] == "weight" else 0.0)
        elif p.ndim == 1:
            p.zero_()
        else:   # a Dense weight [out, in]
            draw = torch.empty(p.shape, device=p.device, dtype=torch.float32)
            nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0,
                                  generator=generator)
            p.copy_(draw / (math.sqrt(p.shape[1]) * _TRUNC_STD))
    return model


class BertForSequenceClassification(nn.Module):
    """The recipe's fine-tuning head: ``[B, num_labels]`` logits in the
    policy's output dtype."""

    def __init__(self, config: BertConfig, num_labels: int = 2, *,
                 device: DeviceLike = None, policy: Optional[Policy] = None):
        super().__init__()
        policy = policy or current_policy()
        device = resolve_device(device)
        self.config = config
        self.num_labels = num_labels
        self.policy = policy
        self.bert = BertModel(config, device=device, policy=policy)
        self.classifier = Dense(config.hidden_size, num_labels,
                                policy=policy, device=device)

    def init_weights(self, generator: torch.Generator):
        return _init_bert(self, generator)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None, *,
                train: bool = False, generator=None,
                attn_impl: Optional[str] = None):
        """``train=True`` applies dropout with masks from ``generator``;
        ``attn_impl`` is passed to every layer's ``attention`` call
        (``None``: flash on the card)."""
        _, pooled = self.bert(input_ids, attention_mask, token_type_ids,
                              train=train, generator=generator,
                              attn_impl=attn_impl)
        pooled = dropout(pooled.to(self.policy.compute_dtype),
                         self.config.dropout_rate, train, generator)
        return self.classifier(pooled).to(self.policy.output_dtype)


class BertForMaskedLM(nn.Module):
    """The MLM pretraining head (HF ``BertForMaskedLM``'s shape): Dense,
    GELU, LayerNorm, then a decoder tied to ``word_embeddings`` (one
    ``[V, H]`` table embeds and un-embeds) plus the free ``mlm_bias``.
    Returns ``[B, S, V]`` logits in f32: the product in the compute dtype,
    the bias added in f32."""

    def __init__(self, config: BertConfig, *, device: DeviceLike = None,
                 policy: Optional[Policy] = None):
        super().__init__()
        policy = policy or current_policy()
        device = resolve_device(device)
        self.config = config
        self.policy = policy
        H = config.hidden_size
        kw = dict(policy=policy, device=device)
        self.bert = BertModel(config, device=device, policy=policy)
        self.mlm_dense = Dense(H, H, **kw)
        self.mlm_ln = LayerNorm(H, config.layer_norm_eps, **kw)
        self.mlm_bias = nn.Parameter(torch.zeros(
            config.vocab_size, device=device, dtype=policy.param_dtype))

    def init_weights(self, generator: torch.Generator):
        return _init_bert(self, generator)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None, *,
                train: bool = False, generator=None,
                attn_impl: Optional[str] = None):
        cd = self.policy.compute_dtype
        x, pooled, table = self.bert(
            input_ids, attention_mask, token_type_ids, train=train,
            generator=generator, attn_impl=attn_impl,
            return_embed_table=True)
        h = F.gelu(self.mlm_dense(x.to(cd)), approximate="none")
        h = self.mlm_ln(h)
        logits = torch.matmul(h, table.to(cd).t())
        # the pooler takes part with weight 0: its gradient is exactly 0,
        # as in the JAX tree (which holds the pooler too), so AdamW decays
        # it as optax does, and DDP finds every parameter in the graph
        return logits.float() + self.mlm_bias.float() + 0.0 * pooled.sum()


def mask_tokens(
    generator: torch.Generator,
    input_ids: torch.Tensor,
    *,
    mask_token_id: int,
    vocab_size: int,
    mask_prob: float = 0.15,
    special_mask: Optional[torch.Tensor] = None,
):
    """BERT's 80/10/10 dynamic masking on the device, drawn from
    ``generator``: each position is selected with ``mask_prob`` (never
    where ``special_mask``, ``[B, S]`` bool, is True); a selected one
    becomes ``mask_token_id`` with probability 0.8, a uniform random id
    with 0.1, and stays itself with 0.1. Returns ``(masked_ids, labels)``
    with ``labels == -100`` (the ignore index) at unselected positions.
    The draws are torch's, not JAX's: the two packages agree on this
    contract, not on which positions a seed selects."""
    dev, shape = input_ids.device, input_ids.shape
    sel = torch.rand(shape, generator=generator, device=dev) < mask_prob
    if special_mask is not None:
        sel = sel & ~special_mask.to(torch.bool)
    labels = torch.where(sel, input_ids, torch.full_like(input_ids, -100))
    op = torch.rand(shape, generator=generator, device=dev)
    random_ids = torch.randint(0, vocab_size, shape, generator=generator,
                               device=dev, dtype=input_ids.dtype)
    masked = torch.where(
        op < 0.8, torch.full_like(input_ids, mask_token_id),
        torch.where(op < 0.9, random_ids, input_ids))
    return torch.where(sel, masked, input_ids), labels


def bert_partition_rules():
    """Megatron-style TP: column-parallel QKV/up, row-parallel out/down;
    the QKV kernels ``[hidden, heads, head_dim]`` shard on heads, the
    embeddings on hidden."""
    from pytorch_distributed_tpu_torch.parallel.rules import P

    return [
        (r"attn/(query|key|value)/kernel", P(None, "tp", None)),
        (r"attn/(query|key|value)/bias", P("tp", None)),
        (r"attn/out/kernel", P("tp", None, None)),
        (r"mlp_up/kernel", P(None, "tp")),
        (r"mlp_up/bias", P("tp")),
        (r"mlp_down/kernel", P("tp", None)),
        (r"_embeddings/embedding", P(None, "tp")),
    ]
