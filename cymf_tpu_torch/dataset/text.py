"""Corpus -> co-occurrence matrix.  Port of `cymf_tpu/dataset/text.py`
(``read_text``, the reference's `glove.pyx:183-241`).

The semantics, as in the JAX package:

* the whole file is read; newlines are replaced by ``<eos>`` tokens for the
  frequency count, then the text is processed line by line;
* words with corpus frequency < ``min_count`` are dropped; vocabulary ids
  are assigned in first-seen order;
* co-occurrence uses a **left window only** with ``1/distance`` weighting,
  accumulated under the key ``center + context * vocab_size``;
* result: ``scipy.csr_matrix`` of shape (V, V) plus the id->word map.

The accumulation runs in the native library
(:func:`cymf_tpu_torch.native.cooccurrence`).  Where the JAX package
falls back to :func:`_python_cooccurrence` when its extension is absent,
this raises the library's ``RuntimeError``: a corpus the size of text8
would otherwise take many times longer without a word.
:func:`_python_cooccurrence` stays as the plain form the tests hold the
library to.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Tuple

import numpy as np
from scipy import sparse

from .. import native


def _python_cooccurrence(lines_ids, vocab_size: int, window_size: int):
    """Vectorized accumulation: for each line, pairs (j, k) with
    k in [j-window, j) get weight 1/(j-k).  Aggregated per line with numpy,
    merged across lines via sorted unique keys."""
    keys_all = []
    vals_all = []
    for ids in lines_ids:
        n = len(ids)
        if n < 2:
            continue
        ids = np.asarray(ids, dtype=np.int64)
        js = []
        ks = []
        ws = []
        for d in range(1, min(window_size, n - 1) + 1):
            js.append(ids[d:])
            ks.append(ids[:-d])
            ws.append(np.full(n - d, 1.0 / d))
        j = np.concatenate(js)
        k = np.concatenate(ks)
        w = np.concatenate(ws)
        keys_all.append(j + k * vocab_size)
        vals_all.append(w)
    if not keys_all:
        return np.zeros(0, np.int64), np.zeros(0)
    keys = np.concatenate(keys_all)
    vals = np.concatenate(vals_all)
    ukeys, inv = np.unique(keys, return_inverse=True)
    sums = np.zeros(len(ukeys))
    np.add.at(sums, inv, vals)
    return ukeys, sums


def _native_cooccurrence(lines_ids, vocab_size: int, window_size: int):
    """The lines' accumulation in the native library: ``(keys, vals)``
    as :func:`_python_cooccurrence`'s, in the library's order."""
    lens = np.asarray([len(x) for x in lines_ids], np.int64)
    flat = np.fromiter((w for ids in lines_ids for w in ids), np.int64,
                       count=int(lens.sum()))
    return native.cooccurrence(flat, lens, vocab_size, window_size)


def read_text(fname: str, min_count: int = 5, window_size: int = 10
              ) -> Tuple[sparse.csr_matrix, Dict[int, str]]:
    with open(fname) as f:
        raw = f.read()
    count = dict(Counter(raw.replace("\n", "<eos>").split(" ")))
    lines = raw.split("\n")

    w2i: Dict[str, int] = {}
    i2w: Dict[int, str] = {}
    lines_ids = []
    for line in lines:
        ids = []
        for word in line.split(" "):
            if count.get(word, 0) >= min_count:
                if word not in w2i:
                    idx = len(w2i)
                    w2i[word] = idx
                    i2w[idx] = word
                ids.append(w2i[word])
        lines_ids.append(ids)

    vocab_size = len(w2i)
    keys, vals = _native_cooccurrence(lines_ids, vocab_size, window_size)

    row = (keys % vocab_size).astype(np.int64)  # center word
    col = (keys // vocab_size).astype(np.int64)  # context word
    X = sparse.csr_matrix((vals, (row, col)),
                          shape=(vocab_size, vocab_size))
    return X, i2w
