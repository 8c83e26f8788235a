"""BERT, the port of `paddle_tpu/models/bert.py`: `BertModel`, the
pretraining heads and criterion, and sequence classification, under the
JAX package's parameter names.

`BertModel.forward` turns `input_ids != pad_token_id` into a
`[B, 1, 1, S]` bool key-padding mask for the encoder, so in eval (no
attention dropout) every layer's self-attention runs the segmented flash
kernel (K1c) where S % 128 == 0 and head_dim % 64 == 0: real tokens
attend only real tokens, padding only padding. `bert_tiny`'s head_dim
of 32 takes the additive path, as in JAX. Every model takes `device=`,
defaulting to "cuda"; carry a JAX model across with
`convert.load_jax_bert`.
"""
from __future__ import annotations

import torch

from .. import nn
from .._device import resolve_device


class BertEmbeddings(torch.nn.Module):

    def __init__(self, vocab_size, hidden_size, max_position_embeddings,
                 type_vocab_size, hidden_dropout_prob=0.1, *, device="cuda"):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, hidden_size,
                                            device=device)
        self.position_embeddings = nn.Embedding(
            max_position_embeddings, hidden_size, device=device)
        self.token_type_embeddings = nn.Embedding(
            type_vocab_size, hidden_size, device=device)
        self.layer_norm = nn.LayerNorm(hidden_size, device=device)
        self.dropout = nn.Dropout(hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = self.word_embeddings(input_ids) \
            + self.position_embeddings(position_ids) \
            + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(emb))


class BertPooler(torch.nn.Module):

    def __init__(self, hidden_size, *, device="cuda"):
        super().__init__()
        self.dense = nn.Linear(hidden_size, hidden_size, device=device)
        self.activation = nn.Tanh()

    def forward(self, hidden_states):
        return self.activation(self.dense(hidden_states[:, 0]))


class BertModel(torch.nn.Module):

    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_act="gelu",
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=2,
                 initializer_range=0.02, pad_token_id=0, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.pad_token_id = pad_token_id
        self.embeddings = BertEmbeddings(
            vocab_size, hidden_size, max_position_embeddings,
            type_vocab_size, hidden_dropout_prob, device=device)
        encoder_layer = nn.TransformerEncoderLayer(
            hidden_size, num_attention_heads, intermediate_size,
            dropout=hidden_dropout_prob, activation=hidden_act,
            attn_dropout=attention_probs_dropout_prob, act_dropout=0.0,
            device=device)
        self.encoder = nn.TransformerEncoder(encoder_layer,
                                             num_hidden_layers)
        self.pooler = BertPooler(hidden_size, device=device)
        self.hidden_size = hidden_size
        self.vocab_size = vocab_size
        self.num_layers = num_hidden_layers

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        """(sequence output [B, S, hidden], pooled output [B, hidden])."""
        if attention_mask is None:
            attention_mask = input_ids != self.pad_token_id
        mask = attention_mask.bool()[:, None, None, :]
        emb = self.embeddings(input_ids, token_type_ids, position_ids)
        seq_out = self.encoder(emb, src_mask=mask)
        return seq_out, self.pooler(seq_out)


class BertPretrainingHeads(torch.nn.Module):
    """Masked-LM and next-sentence heads. With `embedding_weights` the
    MLM decoder is that table (tied; `named_parameters` names it once,
    under the embedding), plus `decoder_bias`."""

    def __init__(self, hidden_size, vocab_size, activation="gelu",
                 embedding_weights=None, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.transform = nn.Linear(hidden_size, hidden_size, device=device)
        self.activation = nn.GELU()
        self.layer_norm = nn.LayerNorm(hidden_size, device=device)
        self._tied_weight = embedding_weights
        if embedding_weights is None:
            self.decoder = nn.Linear(hidden_size, vocab_size, device=device)
        else:
            self.decoder = None
            self.decoder_bias = torch.nn.Parameter(
                torch.zeros(vocab_size, device=device))
        self.seq_relationship = nn.Linear(hidden_size, 2, device=device)

    def forward(self, sequence_output, pooled_output):
        h = self.layer_norm(self.activation(self.transform(
            sequence_output)))
        if self.decoder is not None:
            prediction_scores = self.decoder(h)
        else:
            prediction_scores = torch.nn.functional.linear(
                h, self._tied_weight, self.decoder_bias.to(h.dtype))
        return prediction_scores, self.seq_relationship(pooled_output)


class BertForPretraining(torch.nn.Module):

    def __init__(self, bert: BertModel):
        super().__init__()
        self.bert = bert
        emb = bert.embeddings.word_embeddings.weight
        self.cls = BertPretrainingHeads(bert.hidden_size, bert.vocab_size,
                                        embedding_weights=emb,
                                        device=emb.device)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        seq_out, pooled = self.bert(input_ids, token_type_ids,
                                    position_ids, attention_mask)
        return self.cls(seq_out, pooled)


class BertPretrainingCriterion(torch.nn.Module):
    """Mean MLM cross entropy over labels other than -1, plus the mean
    next-sentence cross entropy when its labels are given."""

    def __init__(self, vocab_size):
        super().__init__()
        self.vocab_size = vocab_size

    def forward(self, prediction_scores, seq_relationship_score,
                masked_lm_labels, next_sentence_labels=None,
                masked_lm_scale=1.0):
        F = nn.functional
        mlm = F.cross_entropy(
            prediction_scores.reshape(-1, self.vocab_size),
            masked_lm_labels.reshape(-1), ignore_index=-1)
        if next_sentence_labels is None:
            return mlm
        return mlm + F.cross_entropy(seq_relationship_score,
                                     next_sentence_labels.reshape(-1))


class BertForSequenceClassification(torch.nn.Module):

    def __init__(self, bert: BertModel, num_classes=2, dropout=None):
        super().__init__()
        self.bert = bert
        self.dropout = nn.Dropout(dropout if dropout is not None else 0.1)
        self.classifier = nn.Linear(
            bert.hidden_size, num_classes,
            device=bert.embeddings.word_embeddings.weight.device)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, position_ids,
                              attention_mask)
        return self.classifier(self.dropout(pooled))


def bert_tiny(**kw):
    return BertModel(vocab_size=1024, hidden_size=128,
                     num_hidden_layers=2, num_attention_heads=4,
                     intermediate_size=256, max_position_embeddings=128,
                     **kw)


def bert_base(**kw):
    return BertModel(**kw)


def bert_large(**kw):
    return BertModel(hidden_size=1024, num_hidden_layers=24,
                     num_attention_heads=16, intermediate_size=4096, **kw)
