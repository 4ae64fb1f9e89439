"""BERT encoder (ports ``paddle_tpu/models/bert.py``: the BERT
fine-tune rung of the bench ladder, ``bench.py:229``; reference:
paddle.nn.TransformerEncoder semantics,
python/paddle/nn/layer/transformer.py).

Attention goes through llama's registered ``flash_attention`` op, so on
the card BERT-base (12 heads of 64) runs the K1/K2 kernels, non-causal;
a ``[B, 1, 1, S]`` bool key-padding mask routes to the K8 kernels.
"""
from __future__ import annotations

from dataclasses import dataclass

from .. import nn
from ..nn import functional as F
from ..ops.creation import arange
from ..ops.manipulation import concat
from .llama import flash_attention

__all__ = ["BertConfig", "BertEmbeddings", "BertSelfAttention", "BertLayer",
           "BertModel", "BertForSequenceClassification"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    num_labels: int = 2
    dtype: str = "float32"

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


class BertEmbeddings(nn.Layer):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings,
                                                c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size,
                                                  c.hidden_size)
        self.layer_norm = nn.LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps)

    def forward(self, input_ids, token_type_ids=None):
        s = input_ids.shape[1]
        pos = arange(s, dtype="int64").unsqueeze(0)
        e = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            e = e + self.token_type_embeddings(token_type_ids)
        return self.layer_norm(e)


class BertSelfAttention(nn.Layer):
    def __init__(self, c: BertConfig):
        super().__init__()
        h = c.hidden_size
        self.num_heads = c.num_attention_heads
        self.head_dim = c.head_dim
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.dense = nn.Linear(h, h)
        self.layer_norm = nn.LayerNorm(h, epsilon=c.layer_norm_eps)

    def forward(self, x, attn_mask=None):
        b, s, h = x.shape
        shp = [b, s, self.num_heads, self.head_dim]
        # fused QKV, as the reference: one [h, 3h] matmul instead of
        # three [h, h] ones (q/k/v stay separate params in the state)
        w = concat([self.query.weight, self.key.weight,
                    self.value.weight], axis=1)
        bias = concat([self.query.bias, self.key.bias,
                       self.value.bias], axis=0)
        qkv = F.linear(x, w, bias)
        q = qkv[:, :, :h].reshape(shp)
        k = qkv[:, :, h:2 * h].reshape(shp)
        v = qkv[:, :, 2 * h:].reshape(shp)
        out = flash_attention(q, k, v, attn_mask=attn_mask)
        out = self.dense(out.reshape([b, s, h]))
        return self.layer_norm(x + out)


class BertLayer(nn.Layer):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.attention = BertSelfAttention(c)
        self.intermediate = nn.Linear(c.hidden_size, c.intermediate_size)
        self.output = nn.Linear(c.intermediate_size, c.hidden_size)
        self.layer_norm = nn.LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps)

    def forward(self, x, attn_mask=None):
        x = self.attention(x, attn_mask=attn_mask)
        y = self.output(F.gelu(self.intermediate(x)))
        return self.layer_norm(x + y)


class BertModel(nn.Layer):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config)
        self.encoder = nn.LayerList(
            [BertLayer(config) for _ in range(config.num_hidden_layers)])
        self.pooler = nn.Linear(config.hidden_size, config.hidden_size)

    def forward(self, input_ids, token_type_ids=None, attn_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        for layer in self.encoder:
            x = layer(x, attn_mask=attn_mask)
        pooled = F.tanh(self.pooler(x[:, 0]))
        return x, pooled


class BertForSequenceClassification(nn.Layer):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.bert = BertModel(config)
        self.classifier = nn.Linear(config.hidden_size, config.num_labels)

    def forward(self, input_ids, token_type_ids=None, attn_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attn_mask)
        return self.classifier(pooled)
