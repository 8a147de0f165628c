"""Bucketing sentence iterator (counterpart of ``mxnet_tpu/rnn/io.py``).

Buckets pad variable-length sentences to a few fixed lengths, so that each
bucket is one graph of fixed shapes.  The shuffles at each ``reset`` are the
JAX iterator's draws (python's ``random.shuffle`` of the batch order, then
numpy's global ``np.random.shuffle`` of each bucket), so that one seed of
both gives the same batches in both packages.  The batches are made on
``ctx`` (the card unless the CPU is given).
"""
from __future__ import annotations

import random

import numpy as np

from ..base import MXNetError
from ..io.io import DataBatch, DataDesc, DataIter

__all__ = ["BucketSentenceIter", "encode_sentences"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0, unknown_token=None):
    """Encode tokenized sentences into integer ids, building the vocab
    on the fly (reference io.py encode_sentences)."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                if not new_vocab:
                    if unknown_token:
                        word = unknown_token
                    else:
                        raise MXNetError(f"unknown token {word}")
                else:
                    if idx == invalid_label:
                        idx += 1
                    vocab[word] = idx
                    idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Pads each encoded sentence into the smallest bucket that fits and
    yields fixed-shape batches with per-batch bucket_key — feeds
    BucketingModule (reference io.py BucketSentenceIter ~L60)."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT", ctx=None):
        super().__init__(batch_size=batch_size)
        if not buckets:
            buckets = [i for i, j in enumerate(
                np.bincount([len(s) for s in sentences]))
                if j >= batch_size]
        buckets.sort()
        ndiscard = 0
        self.data = [[] for _ in buckets]
        for sent in sentences:
            buck = np.searchsorted(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        # keep empty buckets 2-D so reset()'s label shift is well-formed
        self.data = [np.asarray(i, dtype=dtype).reshape(-1, blen)
                     for i, blen in zip(self.data, buckets)]
        if ndiscard:
            import logging

            logging.getLogger("mxnet_tpu_torch").warning(
                "discarded %d sentences longer than the largest bucket",
                ndiscard)

        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.ctx = ctx
        self.invalid_label = invalid_label
        self.nddata = []
        self.ndlabel = []
        self.major_axis = layout.find("N")
        self.layout = layout
        self.default_bucket_key = max(buckets)

        if self.major_axis == 0:
            self.provide_data = [DataDesc(
                name=self.data_name,
                shape=(batch_size, self.default_bucket_key))]
            self.provide_label = [DataDesc(
                name=self.label_name,
                shape=(batch_size, self.default_bucket_key))]
        elif self.major_axis == 1:
            self.provide_data = [DataDesc(
                name=self.data_name,
                shape=(self.default_bucket_key, batch_size))]
            self.provide_label = [DataDesc(
                name=self.label_name,
                shape=(self.default_bucket_key, batch_size))]
        else:
            raise MXNetError(f"invalid layout {layout}: must contain N")

        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in range(
                0, len(buck) - batch_size + 1, batch_size)])
        self.curr_idx = 0
        self.reset()

    def reset(self):
        from .. import ndarray as nd

        self.curr_idx = 0
        random.shuffle(self.idx)
        for buck in self.data:
            np.random.shuffle(buck)

        self.nddata = []
        self.ndlabel = []
        for buck in self.data:
            label = np.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(nd.array(buck, ctx=self.ctx,
                                        dtype=self.dtype))
            self.ndlabel.append(nd.array(label, ctx=self.ctx,
                                         dtype=self.dtype))

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1

        if self.major_axis == 1:
            data = self.nddata[i][j:j + self.batch_size].T
            label = self.ndlabel[i][j:j + self.batch_size].T
        else:
            data = self.nddata[i][j:j + self.batch_size]
            label = self.ndlabel[i][j:j + self.batch_size]

        return DataBatch(
            [data], [label], pad=0, bucket_key=self.buckets[i],
            provide_data=[DataDesc(name=self.data_name, shape=data.shape)],
            provide_label=[DataDesc(name=self.label_name,
                                    shape=label.shape)])
