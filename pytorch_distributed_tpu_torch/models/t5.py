"""T5 encoder-decoder in PyTorch: the port of
``pytorch_distributed_tpu/models/t5.py``.

HF ``T5ForConditionalGeneration`` semantics, as in the JAX model:

* **T5LayerNorm** is RMS-only (no mean subtraction, no bias), in f32.
* **No attention scaling**: T5 folds ``1/sqrt(d)`` into its init, so the
  logits go into the softmax unscaled (``attention(scale=1.0)``).
* **Relative position bias**: one learned ``[num_buckets, heads]`` table
  per stack (:class:`RelativeBias`, owned by the stack, as in the JAX
  model; HF hangs it on block 0), bucketed log-distance, bidirectional
  in the encoder and causal in the decoder, handed to
  ``ops.attention.attention`` as ``bias_fn(q_pos, k_pos)``: unsharded
  calls materialize it over their positions, ring sequence parallelism
  evaluates it per block from global positions. Cross-attention carries
  no bias.
* **Tied embeddings**: ``shared`` embeds both stacks' inputs and, with
  ``tie_word_embeddings``, is the head: the decoder output is scaled by
  ``d_model ** -0.5`` and projected through the table in the parameter
  dtype (f32 under ``Policy.train()``), as ``shared.attend`` does.
* **Dropout** at HF's sites: the embeddings, each sublayer's residual
  branch, the attention weights (``attention(dropout_rate=...)``), the
  FFN between its activation and ``wo``, and after each stack's final
  norm; masks drawn from the caller's ``torch.Generator``.

The attention calls take the port's dispatch: the encoder's and the
decoder's self-attention carry the bias, so they run on the einsum path;
the cross-attention (``[B, T]`` key mask, ``scale=1.0``, no bias) runs
the flash kernels on the card in training and in every uncached forward.

Decoding: the decoder self-attention writes a ``[B, cache_len]`` K/V
cache per layer (``ops.attention.decode_cache``) and attends with the
cache index as its query offset, so the bias sees the true position; the
cross-attention K/V are projected from the encoder output once, when the
cache is first filled, and reused every token. Every row decodes at the
cache's one index (lockstep, as the JAX model's ``cache_index``).
:func:`generate_encdec` encodes once and decodes through
``generation.generate`` with a decoder wrapper that refuses ragged
prompt masks, as ``T5DecodeWrapper`` does.

``forward`` is the one entry point (``encode`` and ``decode`` call it),
so a model sharded by ``parallel.DataParallel``/``FSDP`` gathers its
parameters for every part. Under tensor parallelism
(:func:`t5_partition_rules`) q/k/v and ``wi`` are column-parallel, ``o``
and ``wo`` row-parallel, ``shared`` is sharded on hidden (its lookups
gathered whole, the tied head through the gathered table) and each
stack's bias table on heads: each rank reads the bias of its own heads.
``scan_layers`` is a fact of the JAX tree's layout only (the converters
in ``interop.py`` read and write it); the port's layers are an
``nn.ModuleList``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_tpu_torch.models.gpt2 import dropout
from pytorch_distributed_tpu_torch.models.llama import Linear
from pytorch_distributed_tpu_torch.models.scan import remat_call
from pytorch_distributed_tpu_torch.ops.attention import (
    attention,
    decode_cache,
    init_layer_cache,
)
from pytorch_distributed_tpu_torch.runtime.device import (
    DeviceLike,
    resolve_device,
)
from pytorch_distributed_tpu_torch.runtime.mesh import shard_box, whole_tensor
from pytorch_distributed_tpu_torch.runtime.precision import (
    Policy,
    current_policy,
)


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32_128
    d_model: int = 512
    d_kv: int = 64  # per-head dim (not d_model // heads in general)
    d_ff: int = 2_048
    num_layers: int = 6  # encoder layers == decoder layers
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    dropout_rate: float = 0.1
    layer_norm_eps: float = 1e-6
    feed_forward_proj: str = "relu"  # relu (t5) | gated-gelu (t5 v1.1)
    tie_word_embeddings: bool = True  # v1.1 unties
    pad_token_id: int = 0  # doubles as decoder_start_token_id
    eos_token_id: int = 1
    scan_layers: bool = True  # the JAX tree's layout (converters only)
    remat: bool = False
    remat_policy: str = "full"

    def __post_init__(self):
        if self.feed_forward_proj not in ("relu", "gated-gelu"):
            raise ValueError(
                f"feed_forward_proj must be 'relu' or 'gated-gelu', got "
                f"{self.feed_forward_proj!r}")

    @classmethod
    def small(cls) -> "T5Config":
        return cls()

    @classmethod
    def base(cls) -> "T5Config":
        return cls(d_model=768, d_ff=3072, num_layers=12, num_heads=12)

    @classmethod
    def tiny(cls) -> "T5Config":
        return cls(
            vocab_size=512, d_model=64, d_kv=16, d_ff=128, num_layers=2,
            num_heads=4, relative_attention_num_buckets=8,
            relative_attention_max_distance=32,
        )


class T5LayerNorm(nn.Module):
    """RMS-only norm: ``x * rsqrt(mean(x^2) + eps) * scale`` in f32, the
    input's dtype out."""

    def __init__(self, dim: int, eps: float, *, device, dtype):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device,
                                              dtype=dtype))

    def forward(self, x):
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps)
                * self.weight.float()).to(x.dtype)


def relative_position_bucket(relative_position: torch.Tensor, *,
                             bidirectional: bool, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """T5's bucketed log-distance (the JAX model's arithmetic): half the
    buckets are exact small distances, the other half log-spaced out to
    ``max_distance``; bidirectional splits the space by sign. The log
    runs in f32 with the JAX model's ``1e-9`` and truncates toward zero,
    so the buckets equal the JAX ones."""
    rp = relative_position
    bucket = torch.zeros_like(rp)
    if bidirectional:
        num_buckets //= 2
        bucket = bucket + torch.where(rp > 0, num_buckets, 0)
        rp = rp.abs()
    else:
        rp = -torch.clamp(rp, max=0)
    max_exact = num_buckets // 2
    is_small = rp < max_exact
    denom = torch.log(torch.tensor(max_distance / max_exact,
                                   dtype=torch.float32, device=rp.device))
    scaled = (torch.log(rp.float() / max_exact + 1e-9) / denom
              * (num_buckets - max_exact))
    log_big = max_exact + scaled.to(rp.dtype)   # truncates toward zero
    log_big = torch.clamp(log_big, max=num_buckets - 1)
    return bucket + torch.where(is_small, rp, log_big)


def relative_bias_from_table(table, q_positions, k_positions, *,
                             bidirectional: bool, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """``[num_buckets, H]`` table and positions -> the additive bias
    ``[H, S, T]`` in f32."""
    rel = k_positions[None, :].long() - q_positions[:, None].long()
    bucket = relative_position_bucket(
        rel, bidirectional=bidirectional, num_buckets=num_buckets,
        max_distance=max_distance)
    return table[bucket].permute(2, 0, 1).float()


class RelativeBias(nn.Module):
    """A stack's ``[num_buckets, heads]`` table (``weight``, the JAX
    ``rel_bias/embedding``). :meth:`bias_fn` is the ``bias_fn(q_pos,
    k_pos)`` its stack hands to the attention: the heads this rank holds
    (all of them, or this rank's share when tensor parallelism shards the
    table on heads)."""

    # parallel.strategies.place_tables shards the weight itself (no
    # parallel style takes a table read by head)
    tp_table = True

    def __init__(self, cfg: T5Config, bidirectional: bool, *, device,
                 dtype):
        super().__init__()
        self.cfg = cfg
        self.bidirectional = bidirectional
        self.weight = nn.Parameter(torch.empty(
            cfg.relative_attention_num_buckets, cfg.num_heads,
            device=device, dtype=dtype))

    def local_table(self) -> torch.Tensor:
        from torch.distributed.tensor import DTensor

        w = self.weight
        return w.to_local() if isinstance(w, DTensor) else w

    def bias_fn(self):
        cfg, table = self.cfg, self.local_table()

        def fn(q_pos, k_pos):
            return relative_bias_from_table(
                table, q_pos, k_pos, bidirectional=self.bidirectional,
                num_buckets=cfg.relative_attention_num_buckets,
                max_distance=cfg.relative_attention_max_distance)

        return fn


class T5Attention(nn.Module):
    """Self- or cross-attention, T5's: unscaled logits, bias-free q, k,
    v and o."""

    def __init__(self, cfg: T5Config, *, causal: bool, policy: Policy,
                 device):
        super().__init__()
        self.cfg = cfg
        self.causal = causal
        inner = cfg.num_heads * cfg.d_kv
        lin = lambda i, o: Linear(i, o, policy=policy,  # noqa: E731
                                  device=device)
        self.q = lin(cfg.d_model, inner)
        self.k = lin(cfg.d_model, inner)
        self.v = lin(cfg.d_model, inner)
        self.o = lin(inner, cfg.d_model)

    def _heads(self, proj, x):
        B, S, _ = x.shape
        return proj(x).view(B, S, -1, self.cfg.d_kv)

    def forward(self, x, *, kv_source=None, bias_fn=None, mask=None,
                cache=None, layer: int = 0, train: bool = False,
                generator=None, attn_impl: Optional[str] = None):
        """``kv_source`` None: self-attention (with ``cache``, the decode
        step writes its K/V at the cache index and attends from it);
        else cross-attention over ``kv_source`` (with ``cache``, K/V
        projected once, on the first call, and reused)."""
        cfg = self.cfg
        B, S, _ = x.shape
        q = self._heads(self.q, x)
        offset = 0
        if kv_source is None:
            k, v = self._heads(self.k, x), self._heads(self.v, x)
            if cache is not None:
                if cache.self_kv[layer] is None:   # this rank's heads
                    cache.self_kv[layer] = init_layer_cache(
                        B, cache.length, k.shape[2], cfg.d_kv,
                        dtype=k.dtype, device=k.device)
                pos = torch.full((B,), cache.index, dtype=torch.int32,
                                 device=x.device)
                k, v, _ = decode_cache(cache.self_kv[layer], k, v,
                                       write_pos=pos, paged=None)
                offset = cache.index
        elif cache is not None:
            if cache.cross_kv[layer] is None:
                cache.cross_kv[layer] = (self._heads(self.k, kv_source),
                                         self._heads(self.v, kv_source))
            k, v = cache.cross_kv[layer]
        else:
            k, v = self._heads(self.k, kv_source), self._heads(self.v,
                                                               kv_source)
        rate = cfg.dropout_rate if train else 0.0
        out = attention(q, k, v, causal=self.causal, mask=mask,
                        q_offset=offset, scale=1.0, bias_fn=bias_fn,
                        dropout_rate=rate, generator=generator,
                        impl=attn_impl)
        return self.o(out.reshape(B, S, -1))


class T5FFN(nn.Module):
    """``wo(drop(relu(wi x)))``, or gated-gelu's ``wo(drop(gelu(wi_0 x) *
    wi_1 x))`` (tanh-approximate gelu, HF's ``gelu_new``)."""

    def __init__(self, cfg: T5Config, *, policy: Policy, device):
        super().__init__()
        self.cfg = cfg
        lin = lambda i, o: Linear(i, o, policy=policy,  # noqa: E731
                                  device=device)
        if cfg.feed_forward_proj == "gated-gelu":
            self.wi_0 = lin(cfg.d_model, cfg.d_ff)
            self.wi_1 = lin(cfg.d_model, cfg.d_ff)
        else:
            self.wi = lin(cfg.d_model, cfg.d_ff)
        self.wo = lin(cfg.d_ff, cfg.d_model)

    def forward(self, x, *, train: bool = False, generator=None):
        cfg = self.cfg
        if cfg.feed_forward_proj == "gated-gelu":
            h = F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x)
        else:
            h = F.relu(self.wi(x))
        h = dropout(h, cfg.dropout_rate, train, generator)
        return self.wo(h)


class T5Block(nn.Module):
    """An encoder block (self-attention, FFN) or, with ``cross``, a
    decoder block (causal self-attention, cross-attention, FFN), each
    sublayer pre-normed with a dropped residual branch."""

    def __init__(self, cfg: T5Config, *, cross: bool, policy: Policy,
                 device):
        super().__init__()
        self.cfg = cfg
        self.cross = cross
        norm = lambda: T5LayerNorm(  # noqa: E731
            cfg.d_model, cfg.layer_norm_eps, device=device,
            dtype=policy.param_dtype)
        kw = dict(policy=policy, device=device)
        self.attn_norm = norm()
        self.attn = T5Attention(cfg, causal=cross, **kw)
        if cross:
            self.cross_norm = norm()
            self.cross_attn = T5Attention(cfg, causal=False, **kw)
        self.ffn_norm = norm()
        self.ffn = T5FFN(cfg, **kw)

    def forward(self, x, bias_fn, enc_out, enc_mask, *, train: bool,
                generator, cache=None, layer: int = 0,
                attn_impl: Optional[str] = None):
        if self.cfg.remat and cache is None and torch.is_grad_enabled():
            def run(x, enc_out, enc_mask, generator):
                return self._forward(x, bias_fn, enc_out, enc_mask,
                                     train=train, generator=generator,
                                     cache=None, layer=layer,
                                     attn_impl=attn_impl)
            return remat_call(run, x, enc_out, enc_mask, generator=generator,
                              policy=self.cfg.remat_policy)
        return self._forward(x, bias_fn, enc_out, enc_mask, train=train,
                             generator=generator, cache=cache, layer=layer,
                             attn_impl=attn_impl)

    def _forward(self, x, bias_fn, enc_out, enc_mask, *, train, generator,
                 cache, layer, attn_impl):
        rate = self.cfg.dropout_rate
        kw = dict(train=train, generator=generator, attn_impl=attn_impl)
        h = self.attn(self.attn_norm(x), bias_fn=bias_fn,
                      mask=None if self.cross else enc_mask, cache=cache,
                      layer=layer, **kw)
        x = x + dropout(h, rate, train, generator)
        if self.cross:
            h = self.cross_attn(self.cross_norm(x), kv_source=enc_out,
                                mask=enc_mask, cache=cache, layer=layer, **kw)
            x = x + dropout(h, rate, train, generator)
        h = self.ffn(self.ffn_norm(x), train=train, generator=generator)
        return x + dropout(h, rate, train, generator)


class T5Stack(nn.Module):
    """The encoder (``cross=False``) or the decoder: its bias table, its
    blocks (``layers``) and its final norm."""

    def __init__(self, cfg: T5Config, *, cross: bool, policy: Policy,
                 device):
        super().__init__()
        self.cfg = cfg
        self.rel_bias = RelativeBias(cfg, bidirectional=not cross,
                                     device=device,
                                     dtype=policy.param_dtype)
        self.layers = nn.ModuleList(
            T5Block(cfg, cross=cross, policy=policy, device=device)
            for _ in range(cfg.num_layers))
        self.final_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps,
                                      device=device,
                                      dtype=policy.param_dtype)

    def forward(self, x, enc_out=None, enc_mask=None, *, train: bool,
                generator, cache=None, attn_impl: Optional[str] = None):
        bias_fn = self.rel_bias.bias_fn()
        for i, block in enumerate(self.layers):
            x = block(x, bias_fn, enc_out, enc_mask, train=train,
                      generator=generator, cache=cache, layer=i,
                      attn_impl=attn_impl)
        x = self.final_norm(x)
        return dropout(x, self.cfg.dropout_rate, train, generator)


@dataclasses.dataclass
class T5DecodeCache:
    """The decoder's decode state: per layer the self-attention's ``(k,
    v)`` buffers ``[B, length, H, d_kv]`` (H this rank's heads, in the
    compute dtype) and the once-projected cross-attention ``(k, v)``,
    both None until the first call fills them, and the cache index every
    row writes at next."""

    length: int
    self_kv: List[Optional[tuple]]
    cross_kv: List[Optional[tuple]]
    index: int = 0


class T5ForConditionalGeneration(nn.Module):
    """Returns ``[B, S_dec, vocab]`` logits in the policy's output dtype.

    ``model(input_ids, decoder_input_ids, input_mask=...)`` runs both
    stacks; :meth:`encode` and :meth:`decode` run one (``forward`` with
    ``decoder_input_ids`` or ``input_ids`` left out). ``train=True``
    applies dropout with masks from ``generator``; ``attn_impl`` is passed
    to every attention call (``None``: the flash kernels on the card
    where the dispatch takes a call). A model built without a policy
    takes ``runtime.precision.current_policy()``."""

    def __init__(self, config: T5Config, *, device: DeviceLike = None,
                 policy: Optional[Policy] = None):
        super().__init__()
        device = resolve_device(device)
        policy = policy or current_policy()
        self.config = config
        self.policy = policy
        self.shared = nn.Embedding(config.vocab_size, config.d_model,
                                   device=device, dtype=policy.param_dtype)
        self.encoder = T5Stack(config, cross=False, policy=policy,
                               device=device)
        self.decoder = T5Stack(config, cross=True, policy=policy,
                               device=device)
        self.lm_head = None if config.tie_word_embeddings else Linear(
            config.d_model, config.vocab_size, policy=policy, device=device)

    @property
    def device(self) -> torch.device:
        return self.decoder.final_norm.weight.device

    def shard_blocks(self) -> List[nn.Module]:
        """The units FSDP wraps one by one: every block of both stacks."""
        return list(self.encoder.layers) + list(self.decoder.layers)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Seeded weights drawn as flax's initializers draw the JAX
        model's: every kernel and the embedding normal with variance
        ``1 / fan_in`` (the ``[out, in]`` weight's ``in``; the table's
        ``d_model``), the bias tables standard normal, the norms one.

        Each tensor is drawn whole, in ``named_parameters`` order, and a
        parameter sharded by FSDP or TP keeps only its own box of the
        draw: the weights are the same at every world size."""
        for name, p in self.named_parameters():
            local, offsets, _ = shard_box(p)
            if name.endswith("norm.weight"):
                local.fill_(1.0)
                continue
            full = torch.randn(p.shape, generator=generator,
                               device=local.device, dtype=torch.float32)
            if not name.endswith("rel_bias.weight"):
                full.div_(math.sqrt(p.shape[1]))
            box = tuple(slice(o, o + n) for o, n in zip(offsets, local.shape))
            local.copy_(full[box])
            del full
        return self

    def init_cache(self, length: int) -> T5DecodeCache:
        """An empty decode cache of ``length`` positions (its buffers made
        zeroed at the first call, at the batch and heads it brings)."""
        n = self.config.num_layers
        return T5DecodeCache(length, [None] * n, [None] * n)

    def _embed(self, ids, train, generator):
        x = self.shared(ids).to(self.policy.compute_dtype)
        return dropout(x, self.config.dropout_rate, train, generator)

    def _head(self, x):
        cfg, policy = self.config, self.policy
        if self.lm_head is not None:
            return self.lm_head(x).to(policy.output_dtype)
        # the JAX model's tying arithmetic: the scale rounded to the
        # compute dtype, the product in the param dtype (shared.attend)
        x = x * torch.tensor(cfg.d_model ** -0.5, dtype=x.dtype)
        pd = policy.param_dtype
        logits = F.linear(x.to(pd), whole_tensor(self.shared.weight).to(pd))
        return logits.to(policy.output_dtype)

    def forward(self, input_ids=None, decoder_input_ids=None, *,
                input_mask=None, enc_out=None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                cache: Optional[T5DecodeCache] = None,
                attn_impl: Optional[str] = None):
        """Encode ``input_ids`` (unless ``enc_out`` is given), then decode
        ``decoder_input_ids`` against it; with ``decoder_input_ids`` None
        return the encoder output. ``input_mask`` ``[B, S_enc]`` is the
        encoder's key mask, in both stacks. With ``cache`` the decoder
        runs one decode step (see :class:`T5DecodeCache`) and returns
        ``(logits, cache)``."""
        if input_mask is not None:
            input_mask = input_mask.to(torch.bool)
        if enc_out is None:
            x = self._embed(input_ids, train, generator)
            enc_out = self.encoder(x, enc_mask=input_mask, train=train,
                                   generator=generator, attn_impl=attn_impl)
            if decoder_input_ids is None:
                return enc_out
        x = self._embed(decoder_input_ids, train, generator)
        x = self.decoder(x, enc_out, input_mask, train=train,
                         generator=generator, cache=cache,
                         attn_impl=attn_impl)
        logits = self._head(x)
        if cache is None:
            return logits
        cache.index += decoder_input_ids.shape[1]
        return logits, cache

    def encode(self, input_ids, input_mask=None, *, train: bool = False,
               generator=None, attn_impl: Optional[str] = None):
        """The encoder output ``[B, S_enc, d_model]`` (compute dtype)."""
        return self(input_ids, None, input_mask=input_mask, train=train,
                    generator=generator, attn_impl=attn_impl)

    def decode(self, decoder_input_ids, enc_out, enc_mask=None, *,
               train: bool = False, generator=None, cache=None,
               attn_impl: Optional[str] = None):
        """The decoder's logits against ``enc_out``; with ``cache`` one
        decode step, ``(logits, cache)``."""
        return self(None, decoder_input_ids, input_mask=enc_mask,
                    enc_out=enc_out, train=train, generator=generator,
                    cache=cache, attn_impl=attn_impl)


class T5DecodeWrapper:
    """The decoder as the decoder-only model ``generation.generate``
    drives: the encoder output closed over, the first call (the 1-token
    start prompt) making the cache and projecting the cross K/V, later
    calls reusing both. ``positions`` and ``write_pos`` are the cache
    index on every row in ``generate``'s lockstep loop, which the cache
    keeps itself; ragged prompt masks (``kv_mask``) and paged views are
    refused: T5 decoding starts from one start token, and its
    raggedness is the encoder's ``input_mask``."""

    def __init__(self, model: T5ForConditionalGeneration, enc_out,
                 enc_mask=None):
        self.model = model
        self.enc_out = enc_out
        self.enc_mask = enc_mask

    @property
    def config(self):
        return None   # no absolute-position cap (relative buckets)

    @property
    def device(self) -> torch.device:
        return self.model.device

    def __call__(self, ids, positions=None, *, cache=None, write_pos=None,
                 decode: bool = False, cache_len: Optional[int] = None,
                 **unexpected):
        if unexpected:
            raise NotImplementedError(
                f"T5DecodeWrapper does not support {sorted(unexpected)} "
                "(ragged prompt_mask decoding is a decoder-only-LM "
                "feature; seq2seq raggedness lives in the encoder "
                "input_mask)")
        if not decode:
            raise ValueError("T5DecodeWrapper decodes through the cache "
                             "only (decode=True)")
        if cache is None:
            cache = self.model.init_cache(cache_len)
        return self.model.decode(ids, self.enc_out, self.enc_mask,
                                 cache=cache)


def shift_right(labels: torch.Tensor, start_id: int = 0) -> torch.Tensor:
    """Teacher-forcing decoder input ``[start, y0, y1, ...]`` (HF
    ``_shift_right``)."""
    return torch.cat([torch.full_like(labels[:, :1], start_id),
                      labels[:, :-1]], dim=1)


@torch.no_grad()
def generate_encdec(model: T5ForConditionalGeneration, input_ids, *,
                    max_new_tokens: int, input_mask=None,
                    temperature: float = 0.0, top_k: Optional[int] = None,
                    top_p: Optional[float] = None,
                    generator: Optional[torch.Generator] = None,
                    eos_id: Optional[int] = None,
                    device: DeviceLike = None) -> torch.Tensor:
    """Seq2seq generation: encode once, decode autoregressively. Returns
    ``[B, max_new_tokens]`` (the start token stripped, HF ``generate``'s
    output without its leading pad). ``eos_id`` defaults to the config's
    ``eos_token_id``; ``eos_id=-1`` disables stopping. ``device``
    defaults to the model's."""
    from pytorch_distributed_tpu_torch.generation import generate

    cfg = model.config
    if eos_id is None:
        eos_id = cfg.eos_token_id
    elif eos_id == -1:
        eos_id = None
    device = model.device if device is None else resolve_device(device)
    ids = torch.as_tensor(input_ids, device=device).long()
    mask = None if input_mask is None else torch.as_tensor(
        input_mask, device=device).to(torch.bool)
    enc_out = model.encode(ids, mask)
    dec = T5DecodeWrapper(model, enc_out, mask)
    start = torch.full((ids.shape[0], 1), cfg.pad_token_id,
                       dtype=torch.long, device=device)
    out = generate(dec, start, max_new_tokens=max_new_tokens,
                   temperature=temperature, top_k=top_k, top_p=top_p,
                   generator=generator, eos_id=eos_id,
                   pad_id=cfg.pad_token_id, device=device)
    return out[:, 1:]


def t5_partition_rules():
    """Megatron TP for both stacks, as rules over the JAX leaves
    (``parallel/rules.py``): column-parallel q/k/v/wi (heads, hidden),
    row-parallel o/wo, ``shared`` on the model dim, each stack's bias
    table on heads."""
    from pytorch_distributed_tpu_torch.parallel.rules import (
        TensorRule,
        engine_rules,
    )

    return engine_rules([
        TensorRule(r"/(q|k|v)/kernel", (None, "tp", None)),
        TensorRule(r"/o/kernel", ("tp", None, None)),
        TensorRule(r"/(wi|wi_0|wi_1)/kernel", (None, "tp")),
        TensorRule(r"/wo/kernel", ("tp", None)),
        TensorRule(r"shared/embedding", (None, "tp"), stacked=False),
        TensorRule(r"rel_bias/embedding", (None, "tp"), stacked=False),
    ])
