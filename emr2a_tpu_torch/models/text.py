"""The text towers: CLIP's text transformer and BERT (PubMedBERT-256,
BioMedCLIP's text side).

Port of ``emr2a_tpu/models/text.py``. ``CLIPTextTransformer``: token and
learned position embeddings, pre-LN ``TransformerBlock``s under an additive
causal mask (``make_causal_mask``), a final LN, and the hidden state at the
first eos token ("EOT pooling", as HF takes the argmax of ``ids == eos``).
Its masked attention never takes a fused block, so with W8A8 params its
projections run K5 through ``Int8Dense``.

``BertConfig`` / ``BertLayer`` / ``BertEncoder``: token, learned position and token-type embeddings, an
embedding LayerNorm, post-LN blocks (``LN(x + attn(x))``,
``LN(x + mlp(x))``, eps 1e-12) with an additive padding mask, and the
poolings ``cls`` (open_clip's BiomedCLIP), ``pooler`` (HF's tanh pooler) and
``none``. Parameter names follow the JAX package's tree
(``models/convert.params_from_jax``), so an embedding table is
``<name>.embedding``.

The masked attention never takes a fused block, so with W8A8 params every
projection runs the streaming W8A8 op (K5) through ``Int8Dense``
(``models/layers.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from emr2a_tpu_torch.models.layers import (
    Dense,
    Mlp,
    MultiHeadAttention,
    TransformerBlock,
    make_causal_mask,
    make_padding_mask,
)


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    max_length: int = 77
    hidden_size: int = 512
    num_layers: int = 12
    num_heads: int = 8
    mlp_dim: int = 2048
    activation: str = "quick_gelu"
    ln_eps: float = 1e-5
    eos_token_id: int = 49407
    dtype: torch.dtype = torch.float32


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    max_length: int = 512
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    activation: str = "gelu"
    ln_eps: float = 1e-12
    type_vocab_size: int = 2
    dtype: torch.dtype = torch.float32


class Embed(nn.Module):
    """``flax.linen.Embed``: a lookup into ``embedding`` (num, features)."""

    def __init__(self, num: int, features: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num, features, dtype=dtype,
                                                  device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding)


class CLIPTextTransformer(nn.Module):

    def __init__(self, config: CLIPTextConfig, device=None):
        super().__init__()
        cfg = self.config = config
        kw = dict(dtype=cfg.dtype, device=device)
        d = cfg.hidden_size
        self.token_embed = Embed(cfg.vocab_size, d, **kw)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.max_length, d, **kw))
        self.blocks = nn.ModuleList(
            TransformerBlock(d, cfg.num_heads, cfg.mlp_dim,
                             activation=cfg.activation, ln_eps=cfg.ln_eps, **kw)
            for _ in range(cfg.num_layers))
        self.final_ln = nn.LayerNorm(d, eps=cfg.ln_eps, **kw)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids (B, S), padded to max_length with the pad / eos id ->
        (B, hidden) at the first eos position (position 0 where a row has
        none, as argmax gives)."""
        B, S = input_ids.shape
        tok = self.token_embed(input_ids)
        x = tok + self.pos_embed[:, :S].to(tok.dtype)
        mask = make_causal_mask(S, device=x.device)
        for block in self.blocks:
            x = block(x, mask)
        x = self.final_ln(x)
        eot = (input_ids == self.config.eos_token_id).to(torch.int32).argmax(dim=-1)
        return x[torch.arange(B, device=x.device), eot]


class BertLayer(nn.Module):
    """Post-LN BERT block: LN(x + attn(x)); LN(x + mlp(x))."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_dim: int,
                 activation: str, ln_eps: float,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.attn = MultiHeadAttention(hidden_size, num_heads, **kw)
        self.attn_ln = nn.LayerNorm(hidden_size, eps=ln_eps, **kw)
        self.mlp = Mlp(hidden_size, mlp_dim, activation=activation, **kw)
        self.mlp_ln = nn.LayerNorm(hidden_size, eps=ln_eps, **kw)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.attn_ln(x + self.attn(x, mask))
        return self.mlp_ln(x + self.mlp(x))


class BertEncoder(nn.Module):

    def __init__(self, config: BertConfig, pooling: str = "cls", device=None):
        super().__init__()
        if pooling not in ("cls", "pooler", "none"):
            raise ValueError(f"unknown pooling {pooling}")
        cfg = self.config = config
        self.pooling = pooling
        kw = dict(dtype=cfg.dtype, device=device)
        d = cfg.hidden_size
        self.token_embed = Embed(cfg.vocab_size, d, **kw)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.max_length, d, **kw))
        self.type_embed = Embed(cfg.type_vocab_size, d, **kw)
        self.embed_ln = nn.LayerNorm(d, eps=cfg.ln_eps, **kw)
        self.blocks = nn.ModuleList(
            BertLayer(d, cfg.num_heads, cfg.mlp_dim, cfg.activation,
                      cfg.ln_eps, **kw)
            for _ in range(cfg.num_layers))
        if pooling == "pooler":
            self.pooler = Dense(d, d, **kw)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """input_ids (B, S) -> (B, hidden), or (B, S, hidden) with
        pooling="none"; attention_mask (B, S) 1 for tokens, 0 for padding."""
        S = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        tok = self.token_embed(input_ids)
        x = (tok + self.pos_embed[:, :S].to(tok.dtype)
             + self.type_embed(token_type_ids))
        x = self.embed_ln(x)
        mask = (make_padding_mask(attention_mask)
                if attention_mask is not None else None)
        for block in self.blocks:
            x = block(x, mask)
        if self.pooling == "cls":
            return x[:, 0]
        if self.pooling == "pooler":
            return torch.tanh(self.pooler(x[:, 0]))
        return x
