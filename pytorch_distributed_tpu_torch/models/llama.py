"""Llama-3 in PyTorch: the port of ``pytorch_distributed_tpu/models/llama.py``.

Decoder with RMSNorm, rotary positions (theta 500k), grouped-query
attention (32 q / 8 kv heads at 8B) and a SwiGLU MLP. The config's
family fields carry the Llama-body families (``models/gemma.py``,
``mistral.py``, ``qwen2.py``, ``qwen3.py``, ``phi3.py``) as the JAX
package's do: q/k/v biases (``attention_bias``), a head that is the
embedding table (``tie_word_embeddings``: one ``Parameter``,
``embed.weight``), a head dim decoupled from ``hidden / heads``
(``override_head_dim``), RMSNorm scaling by ``1 + scale`` with the scale
initialised to zeros (``rms_offset``), the tanh-approximate gelu gate
(``hidden_act="gelu"``), embeddings times ``sqrt(hidden)`` in the
compute dtype (``scale_embedding``) and a per-head RMSNorm on q and k
before RoPE (``qk_norm``). The layers are an
``nn.ModuleList`` (the JAX package scans one stacked block), and the
per-layer KV cache is an explicit argument and return value of
``forward`` (the JAX package keeps it in flax's ``cache`` collection).

Under tensor parallelism (``llama_partition_rules``, applied by
``parallel.FSDP`` with ``tp > 1``) a block's q/k/v/gate/up are
column-parallel and o/down row-parallel: each rank holds ``H / tp``
query heads, and the block reads its head counts off its projections'
outputs. When k/v replicate (MQA, or kv heads that ``tp`` does not
divide) a rank keeps only the kv heads its own query heads use
(:func:`local_kv_heads`), as GSPMD does implicitly in the JAX model, and
the gradient of the whole k/v sums over ``tp`` (each rank's queries
reach only their own kv heads).

The dtype policy works as flax's ``dtype``/``param_dtype`` pair does:
parameters live in ``policy.param_dtype`` (f32 under
``Policy.train()``, bf16 for serving) and every product casts its weight
to ``policy.compute_dtype`` at the use; RMSNorm takes its statistics and
multiplies by its scale in f32 and returns its input's dtype; the head
multiplies in the compute dtype and the logits leave in the output
dtype. Packed training rows carry ``segment_ids`` and per-document
``positions`` (the flash kernels mask across documents). With
``config.remat`` each block recomputes its activations in the backward
(``models/scan.py``): the checkpoint sits inside the block's own
``forward``, so a block wrapped by FSDP gathers its weights once for the
forward and once for the recompute. Llama has no dropout: ``train``
changes nothing in the forward, as in the JAX model.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_tpu_torch.models.scan import remat_call
from pytorch_distributed_tpu_torch.ops.attention import (
    apply_rope,
    attention,
    decode_cache,
    init_layer_cache,
    rope_frequencies,
    validate_write_pos,
)
from pytorch_distributed_tpu_torch.ops.paged_attention import PagedView
from pytorch_distributed_tpu_torch.runtime.device import (
    DeviceLike,
    resolve_device,
)
from pytorch_distributed_tpu_torch.runtime.distributed import sum_grad
from pytorch_distributed_tpu_torch.runtime.mesh import (
    shard_box,
    sharded_over,
    whole_tensor,
)
from pytorch_distributed_tpu_torch.runtime.precision import Policy

#: per-layer (k, v) buffers: dense [B, T, Hkv, D] or a page pool
KVCache = List[Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Context-window extension for RoPE: ``type`` "linear" (position
    interpolation) or "llama3" (HF Llama-3.1 frequency-dependent
    scheme)."""

    type: str = "llama3"
    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8_192


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    hidden_size: int = 4_096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    intermediate_size: int = 14_336
    max_seq_len: int = 8_192
    rope_theta: float = 500_000.0
    rms_eps: float = 1e-5
    # position i sees keys in (i - window, i] only; None = full causal
    sliding_window: Optional[int] = None
    rope_scaling: Optional[RopeScaling] = None
    # biases on the q/k/v projections (Qwen2); o/gate/up/down never carry
    # one in any Llama-body family
    attention_bias: bool = False
    # the head is the embedding table (Llama-3.2-1B/3B, Gemma)
    tie_word_embeddings: bool = False
    # an explicit per-head dim (Gemma: 256), decoupled from hidden/heads
    override_head_dim: Optional[int] = None
    # RMSNorm multiplies by (1 + scale), the scale initialised to zeros
    rms_offset: bool = False
    # the MLP gate's activation: silu, or gelu (Gemma's tanh-approximate)
    hidden_act: str = "silu"
    # embeddings times sqrt(hidden_size) after the lookup (Gemma)
    scale_embedding: bool = False
    # per-head RMSNorm on q and k before RoPE (Qwen3)
    qk_norm: bool = False
    # "int8": the decode cache (dense or paged) rests quantized (lossy);
    # paged int8 pools attend on the gather path, not the kernel
    kv_cache_quantize: Optional[str] = None
    # recompute each block's activations in the backward (models/scan.py)
    remat: bool = False
    remat_policy: str = "full"  # full | dots | dots_no_batch

    def __post_init__(self):
        if self.hidden_act not in ("silu", "gelu"):
            raise ValueError(
                f"hidden_act must be 'silu' or 'gelu', got "
                f"{self.hidden_act!r}"
            )
        if self.kv_cache_quantize not in (None, "int8"):
            raise ValueError(
                f"kv_cache_quantize must be None or 'int8', got "
                f"{self.kv_cache_quantize!r}"
            )

    @property
    def head_dim(self) -> int:
        if self.override_head_dim is not None:
            return self.override_head_dim
        return self.hidden_size // self.num_heads

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def llama3_2_1b(cls) -> "LlamaConfig":
        """Llama-3.2-1B: tied embeddings, factor-32 llama3 rope scaling."""
        return cls(
            hidden_size=2_048, num_layers=16, num_heads=32,
            num_kv_heads=8, intermediate_size=8_192,
            max_seq_len=131_072, tie_word_embeddings=True,
            rope_scaling=RopeScaling(
                type="llama3", factor=32.0, low_freq_factor=1.0,
                high_freq_factor=4.0,
                original_max_position_embeddings=8_192,
            ),
        )

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        return cls(
            vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=128, max_seq_len=128,
        )


class RMSNorm(nn.Module):
    """Statistics and scale in f32, the input's dtype out. With ``offset``
    (Gemma) the weight is zero-centred: it starts at zeros and the norm
    multiplies by ``1 + weight``."""

    def __init__(self, dim: int, eps: float, *, device, dtype,
                 offset: bool = False):
        super().__init__()
        self.eps = eps
        self.offset = offset
        init = torch.zeros if offset else torch.ones
        self.weight = nn.Parameter(init(dim, device=device, dtype=dtype))

    def forward(self, x):
        x32 = x.float()
        rms = torch.sqrt(x32.square().mean(dim=-1, keepdim=True) + self.eps)
        mult = self.weight.float()
        if self.offset:
            mult = 1.0 + mult
        return (x32 / rms * mult).to(x.dtype)


class Linear(nn.Linear):
    """``y = x W^T (+ b)``, W ``[out, in]`` (and b) kept in the policy's
    param dtype and cast, with x, to its compute dtype for the product
    (no copy when the two agree, as when serving)."""

    def __init__(self, in_features: int, out_features: int, *,
                 policy: Policy, device, bias: bool = False):
        super().__init__(in_features, out_features, bias=bias,
                         device=device, dtype=policy.param_dtype)
        self.compute_dtype = policy.compute_dtype

    def forward(self, x):
        cd = self.compute_dtype
        b = None if self.bias is None else self.bias.to(cd)
        return F.linear(x.to(cd), self.weight.to(cd), b)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device, policy: Policy):
        super().__init__()
        self.cfg = cfg
        D, hd = cfg.hidden_size, cfg.head_dim
        dtype = policy.param_dtype
        lin = lambda i, o, bias=False: Linear(  # noqa: E731
            i, o, policy=policy, device=device, bias=bias
        )
        norm = lambda dim: RMSNorm(  # noqa: E731
            dim, cfg.rms_eps, device=device, dtype=dtype,
            offset=cfg.rms_offset)
        ab = cfg.attention_bias
        self.attn_norm = norm(D)
        self.q = lin(D, cfg.num_heads * hd, ab)
        self.k = lin(D, cfg.num_kv_heads * hd, ab)
        self.v = lin(D, cfg.num_kv_heads * hd, ab)
        if cfg.qk_norm:   # one [head_dim] scale each, shared by the heads
            self.q_norm = norm(hd)
            self.k_norm = norm(hd)
        self.o = lin(cfg.num_heads * hd, D)
        self.mlp_norm = norm(D)
        self._build_ffn(cfg, lin, device=device, policy=policy)
        # (rank, ways, process group) of the tp axis; parallel.FSDP sets it
        self.tp = (0, 1, None)

    def _build_ffn(self, cfg, lin, *, device, policy: Policy):
        """The FFN's modules (the hook a family swaps: Mixtral's experts)."""
        self.gate = lin(cfg.hidden_size, cfg.intermediate_size)
        self.up = lin(cfg.hidden_size, cfg.intermediate_size)
        self.down = lin(cfg.intermediate_size, cfg.hidden_size)

    def _ffn(self, h):
        """``(y, aux)``: the FFN's output, and its load-balance loss (None
        for a dense FFN)."""
        gate = self.gate(h)
        if self.cfg.hidden_act == "silu":
            gate = F.silu(gate)
        else:   # Gemma's tanh-approximate gelu
            gate = F.gelu(gate, approximate="tanh")
        return self.down(gate * self.up(h)), None

    def forward(self, x, cos, sin, positions, layer_cache, write_pos,
                paged: Optional[PagedView], attn_impl: Optional[str] = None,
                segment_ids=None, mask=None):
        """``(x, aux)``: the block's output and its FFN's load-balance loss
        (None for a dense FFN)."""
        cfg = self.cfg
        if cfg.remat and layer_cache is None and torch.is_grad_enabled():
            def run(x, cos, sin, positions, segment_ids, mask, generator):
                return self._forward(x, cos, sin, positions, None, None,
                                     None, attn_impl, segment_ids, mask)
            return remat_call(run, x, cos, sin, positions, segment_ids,
                              mask, generator=None, policy=cfg.remat_policy)
        return self._forward(x, cos, sin, positions, layer_cache, write_pos,
                             paged, attn_impl, segment_ids, mask)

    def _forward(self, x, cos, sin, positions, layer_cache, write_pos,
                 paged, attn_impl, segment_ids, mask):
        cfg = self.cfg
        B, S, _ = x.shape
        hd = cfg.head_dim
        h = self.attn_norm(x)
        # this rank's heads: all of them, or 1/tp under tensor parallelism
        q = self.q(h).view(B, S, -1, hd)
        k = self.k(h).view(B, S, -1, hd)
        v = self.v(h).view(B, S, -1, hd)
        if q.shape[2] != cfg.num_heads and k.shape[2] == cfg.num_kv_heads:
            # k/v whole on every tp rank, each rank's loss reaching them
            # through its own query heads: their gradient sums over tp
            k = sum_grad(k, self.tp[2])
            v = sum_grad(v, self.tp[2])
            k, v = local_kv_heads(k, v, cfg, self.tp[0], q.shape[2])
        if cfg.qk_norm:
            q = self.q_norm(q)
            k = self.k_norm(k)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        offset = 0
        if layer_cache is not None:
            k, v, offset = decode_cache(
                layer_cache, k, v, write_pos=write_pos, paged=paged
            )
        attn = attention(
            q, k, v, causal=True, q_offset=offset, mask=mask,
            segment_ids=segment_ids, window=cfg.sliding_window, paged=paged,
            impl=attn_impl,
        )
        x = x + self.o(attn.reshape(B, S, -1))
        y, aux = self._ffn(self.mlp_norm(x))
        return x + y, aux


def _local_kv_index(cfg: LlamaConfig, rank: int, hq: int):
    """``(first, n)`` of the contiguous kv heads query heads ``[rank *
    hq, (rank + 1) * hq)`` read, or their per-query-head list when they
    are no such run."""
    group = cfg.num_heads // cfg.num_kv_heads
    idx = [(rank * hq + i) // group for i in range(hq)]
    first, n = idx[0], idx[-1] - idx[0] + 1
    if hq % n == 0 and idx == [first + i // (hq // n) for i in range(hq)]:
        return first, n
    return idx


def local_kv_heads(k, v, cfg: LlamaConfig, rank: int, hq: int):
    """The kv heads that query heads ``[rank * hq, (rank + 1) * hq)`` use
    (query head ``i`` reads kv head ``i // G``, ``G = H / Hkv``), from
    k/v ``[B, S, Hkv, D]`` holding every kv head: a contiguous slice when
    the rank's queries fall in whole groups (or within one), else each
    query head's own kv head, gathered (``G = 1`` locally)."""
    sel = _local_kv_index(cfg, rank, hq)
    if isinstance(sel, tuple):
        first, n = sel
        return k[:, :, first:first + n], v[:, :, first:first + n]
    sel = torch.tensor(sel, device=k.device)
    return k.index_select(2, sel), v.index_select(2, sel)


class LlamaForCausalLM(nn.Module):
    """Returns [B, S, vocab] logits (and the cache when decoding), or the
    final hidden states with ``return_hidden=True``. The LM head is
    ``lm_head`` (the Llama-3 layout), or with ``tie_word_embeddings`` the
    embedding table itself (``lm_head`` is then None)."""

    block_cls = LlamaBlock   # a family's block (Mixtral's MoE FFN)

    def __init__(self, config: LlamaConfig, *, device: DeviceLike = None,
                 policy: Policy = Policy()):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.policy = policy
        dt = policy.param_dtype
        self.embed = nn.Embedding(
            config.vocab_size, config.hidden_size, device=device, dtype=dt
        )
        self.layers = nn.ModuleList(
            self.block_cls(config, device=device, policy=policy)
            for _ in range(config.num_layers)
        )
        self.final_norm = RMSNorm(
            config.hidden_size, config.rms_eps, device=device, dtype=dt,
            offset=config.rms_offset,
        )
        self.lm_head = None if config.tie_word_embeddings else Linear(
            config.hidden_size, config.vocab_size, policy=policy,
            device=device)
        self._rope: dict = {}

    @property
    def device(self) -> torch.device:
        return self.final_norm.weight.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02):
        """Seeded random weights: every other tensor (biases too)
        normal(0, std), norms one (zeros with ``rms_offset``: the
        identity either way).

        Each matrix is drawn whole, in ``named_parameters`` order, and a
        parameter sharded by FSDP or TP keeps only its own box of the
        draw, one tensor at a time: the weights are the same at every world size,
        and no rank ever holds more than one whole matrix."""
        for name, p in self.named_parameters():
            local, offsets, _ = shard_box(p)
            if name.endswith("norm.weight"):
                local.fill_(0.0 if self.config.rms_offset else 1.0)
                continue
            full = torch.randn(p.shape, generator=generator,
                               device=local.device, dtype=torch.float32)
            box = tuple(slice(o, o + n) for o, n in zip(offsets, local.shape))
            local.copy_(full[box].mul_(std))
            del full
        return self

    def local_kv_heads(self) -> int:
        """The kv heads this rank's caches hold: all of them, ``Hkv / tp``
        when tensor parallelism shards k/v, or the ones its query heads
        read when k/v stay whole (:func:`local_kv_heads`)."""
        cfg = self.config
        rank, ways, _ = self.layers[0].tp if len(self.layers) else (0, 1,
                                                                    None)
        if ways == 1:
            return cfg.num_kv_heads
        if sharded_over(self.layers[0].k.weight, "tp"):
            return cfg.num_kv_heads // ways
        sel = _local_kv_index(cfg, rank, cfg.num_heads // ways)
        return sel[1] if isinstance(sel, tuple) else len(sel)

    def init_cache(self, batch: int, length: int) -> KVCache:
        """Zeroed per-layer (k, v) buffers [batch, length, Hkv, D] in the
        compute dtype (with ``kv_cache_quantize="int8"``: int8 payloads
        and f32 per-token scales); under tensor parallelism ``Hkv`` is
        this rank's (:meth:`local_kv_heads`). The serving pool calls it
        with batch = page frames and length = page size."""
        cfg = self.config
        return [
            init_layer_cache(batch, length, self.local_kv_heads(),
                             cfg.head_dim,
                             dtype=self.policy.compute_dtype,
                             device=self.device,
                             quantize=cfg.kv_cache_quantize)
            for _ in range(cfg.num_layers)
        ]

    def _rope_tables(self, length: int):
        tabs = self._rope.get(length)
        if tabs is None:
            cfg = self.config
            tabs = rope_frequencies(
                cfg.head_dim, length, cfg.rope_theta,
                scaling=cfg.rope_scaling, device=self.device,
            )
            self._rope[length] = tabs
        return tabs

    def forward(
        self,
        input_ids: torch.Tensor,
        positions: Optional[torch.Tensor] = None,
        *,
        cache: Optional[KVCache] = None,
        write_pos: Optional[torch.Tensor] = None,
        decode: bool = False,
        cache_len: Optional[int] = None,
        paged: Optional[PagedView] = None,
        attn_impl: Optional[str] = None,
        segment_ids: Optional[torch.Tensor] = None,
        kv_mask: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        return_hidden: bool = False,
        return_aux: bool = False,
    ):
        """``decode=False``: a plain causal pass, returns logits (the final
        hidden states in the output dtype with ``return_hidden``, for the
        chunked-vocab loss); with ``return_aux`` ``(that, aux)``, ``aux``
        the sum of the layers' load-balance losses (None without experts),
        for the loss to weigh. ``segment_ids`` [B, S] (packed rows, with
        per-document ``positions``) keep attention inside each document;
        ``train`` and ``generator`` (the train step's dropout stream) are
        accepted as GPT-2's are: Llama has no dropout and draws nothing.

        ``decode=True``: per-row KV-cache decode, returns
        ``(logits, cache)``. ``write_pos`` [B] and ``positions`` [B, S]
        are required; ``cache`` defaults to zeroed ``[B, cache_len]``
        buffers; with ``paged`` the cache is the page pool and attention
        streams it through the paged-attention kernel.

        ``kv_mask`` [B, T] (left-padded prompts) is for decode only.

        ``attn_impl`` is passed to every layer's ``attention`` call
        (``None``: flash on the card where it applies, ``"flash"`` or
        ``"xla"`` to force one).
        """
        cfg = self.config
        B, S = input_ids.shape
        if cache_len is not None and cache_len > cfg.max_seq_len:
            raise ValueError(
                f"cache_len {cache_len} > max_seq_len {cfg.max_seq_len}"
            )
        validate_write_pos(write_pos, decode, positions)
        if decode and write_pos is None:
            raise ValueError("decode=True needs write_pos and positions")
        if not decode and (cache is not None or paged is not None):
            raise ValueError("a cache or paged view needs decode=True")
        if segment_ids is not None and decode:
            raise ValueError(
                "segment_ids (packed training) and decode (KV cache) are "
                "mutually exclusive")
        if kv_mask is not None and not decode:
            raise ValueError(
                "kv_mask is for KV-cache decode (left-padded prompts); "
                "training masks go through the loss/segment machinery")
        cd = self.policy.compute_dtype
        x = self.embed(input_ids).to(cd)
        if cfg.scale_embedding:   # the scale rounded to the compute dtype
            x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=cd)
        if decode:
            table_len = cache_len or cfg.max_seq_len
            if cache is None:
                cache = self.init_cache(B, table_len)
        elif positions is None:
            table_len = S
        else:
            table_len = cfg.max_seq_len
        cos, sin = self._rope_tables(table_len)
        auxes = []
        for i, layer in enumerate(self.layers):
            x, aux = layer(
                x, cos, sin, positions,
                cache[i] if decode else None, write_pos, paged,
                attn_impl=attn_impl, segment_ids=segment_ids, mask=kv_mask,
            )
            if aux is not None:
                auxes.append(aux)
        x = self.final_norm(x)
        aux = torch.stack(auxes).sum() if auxes else None
        if return_hidden:
            out = x.to(self.policy.output_dtype)
            return (out, aux) if return_aux else out
        if self.lm_head is not None:
            logits = self.lm_head(x)
        else:   # tied: x E^T in the compute dtype, as flax's Embed.attend
            logits = F.linear(x.to(cd), whole_tensor(self.embed.weight).to(cd))
        logits = logits.to(self.policy.output_dtype)
        if decode:
            return logits, cache
        return (logits, aux) if return_aux else logits


def llama_partition_rules(num_kv_heads: Optional[int] = None):
    """Megatron TP: column-parallel q/k/v/gate/up, row-parallel o/down;
    the embedding sharded on hidden, the ``lm_head`` kernel on vocab (its
    dim 1), as rules over the JAX leaves (``parallel/rules.py``): any dim
    that does not divide its mesh axes replicates with a once-per-shape
    warning, so MQA and ragged GQA replicate k/v (q/o and the MLP still
    shard), and the scan-stacked layer dim is tolerated.

    ``num_kv_heads=1`` forces the MQA replicate form without consulting
    shapes; other values defer to the shape-based decision."""
    from pytorch_distributed_tpu_torch.parallel.rules import (
        TensorRule,
        engine_rules,
        replicated_rule,
    )

    kv_note = "q/o and the MLP still shard"
    kv = (
        replicated_rule(r"/(k|v)/kernel", 3)
        if num_kv_heads == 1  # forced MQA form, shapes not consulted
        else TensorRule(r"/(k|v)/kernel", (None, "tp", None), note=kv_note)
    )
    return engine_rules([
        TensorRule(r"/q/kernel", (None, "tp", None)),
        kv,
        TensorRule(r"/o/kernel", ("tp", None, None)),
        TensorRule(r"/(gate|up)/kernel", (None, "tp")),
        TensorRule(r"/down/kernel", ("tp", None)),
        TensorRule(r"embed/embedding", (None, "tp"), stacked=False),
        TensorRule(r"lm_head/kernel", (None, "tp"), stacked=False),
    ])
