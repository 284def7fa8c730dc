"""Implicit-feedback dataset base.  Port of `cymf_tpu/dataset/implicit.py`
without pandas or scikit-learn at import.

Holds train/valid/test ``scipy.sparse.lil_matrix`` splits plus user/item
counts; the file-backed loaders (MovieLens, YahooMusic) fill them in.  The
cache root is the JAX package's, ``~/.cymf_tpu`` (``CYMF_TPU_CACHE``
overrides it), shared by every loader through :func:`cache_root`.

The loaders keep their ratings as :class:`Ratings`, numpy columns; the
helpers take those or a pandas frame alike, and pandas is imported only by
the members that return a frame (:meth:`ImplicitFeedbackDataset.to_dataframe`
and the loaders' ``df_*`` properties).  :func:`holdout_split` replays
``sklearn.model_selection.train_test_split(test_size=0.1,
random_state=12345)`` with numpy, the split of every loader.
"""

from __future__ import annotations

import math
import os
from pathlib import Path
from typing import NamedTuple

import numpy as np
from scipy import sparse

CACHE_DIR_NAME = ".cymf_tpu"


def cache_root() -> Path:
    """The dataset cache directory, created on first use:
    ``CYMF_TPU_CACHE`` when set, else ``~/.cymf_tpu``."""
    override = os.environ.get("CYMF_TPU_CACHE")
    root = Path(override) if override else Path.home() / CACHE_DIR_NAME
    root.mkdir(parents=True, exist_ok=True)
    return root


def holdout_split(idx: np.ndarray, test_size: float = 0.1,
                  seed: int = 12345):
    """``(train, test)`` exactly as scikit-learn's ``train_test_split``
    draws them: one ``RandomState(seed)`` permutation, the first
    ``ceil(test_size * n)`` positions are the test part."""
    n = len(idx)
    n_test = math.ceil(test_size * n)
    p = np.random.RandomState(seed).permutation(n)
    return idx[p[n_test:]], idx[p[:n_test]]


class Ratings(NamedTuple):
    """Rating rows as numpy columns (``user``, ``item``, ``rating``), with
    the rows' labels in the source frame (``index``) and, where the file
    has one, ``timestamp``."""
    user: np.ndarray
    item: np.ndarray
    rating: np.ndarray
    index: np.ndarray
    timestamp: np.ndarray | None = None

    def take(self, sel: np.ndarray) -> "Ratings":
        return Ratings(*(None if c is None else c[sel] for c in self))

    def to_frame(self):
        """The rows as the JAX loaders' pandas frame (imports pandas)."""
        import pandas as pd

        cols = {"user": self.user, "item": self.item, "rating": self.rating}
        if self.timestamp is not None:
            cols["timestamp"] = self.timestamp
        return pd.DataFrame(cols, index=self.index)


class ImplicitFeedbackDataset:
    """Base for binarized implicit-feedback datasets.

    Subclasses populate ``train``/``valid``/``test`` (lil matrices of
    shape ``num_user x num_item``) and call :meth:`_finalize`.
    """

    num_user: int
    num_item: int
    train_size: int
    valid_size: int
    test_size: int
    train: sparse.lil_matrix
    valid: sparse.lil_matrix
    test: sparse.lil_matrix

    def __init__(self, dir_name: str, min_rating: float = 4.0) -> None:
        self.root = cache_root()
        self.dir_path = self.root / dir_name
        self.min_rating = float(min_rating)

    def to_matrix(self, df) -> sparse.lil_matrix:
        """``(user, item, rating)`` rows (anything with those columns or
        arrays: a pandas frame, :class:`Ratings`) -> lil_matrix.  Of
        duplicate ``(user, item)`` rows the last wins, as lil assignment
        would (COO alone would sum them)."""
        u = np.asarray(df.user).astype(np.int64)
        i = np.asarray(df.item).astype(np.int64)
        r = np.asarray(df.rating)
        key = u * max(int(i.max(initial=0)) + 1, 1) + i
        # the last occurrence of each key, kept in row order
        _, last = np.unique(key[::-1], return_index=True)
        keep = np.sort(len(key) - 1 - last)
        m = sparse.coo_matrix((r[keep], (u[keep], i[keep])),
                              shape=(self.num_user, self.num_item))
        return m.tolil()

    def to_dataframe(self, matrix):
        """Matrix -> long-form ``(user, item, rating)`` pandas frame, with
        the JAX package's quirk (from the reference's helper): the filter
        is ``rating >= 0``, so zero cells are kept and the frame enumerates
        every (user, item) cell unless a rating is negative."""
        import pandas as pd

        dense = np.asarray(
            matrix.toarray() if sparse.issparse(matrix) else matrix)
        U, I = dense.shape
        df = pd.DataFrame({
            "user": np.repeat(np.arange(U), I),
            "item": np.tile(np.arange(I), U),
            "rating": dense.ravel(),
        })
        return df[df["rating"] >= 0]

    def split(self, df):
        """Rows -> ``(user, item, rating[:, None])`` arrays."""
        return (np.asarray(df.user), np.asarray(df.item),
                np.asarray(df.rating)[:, None])

    def _finalize(self):
        self.train_size = self.train.nnz
        self.valid_size = self.valid.nnz
        self.test_size = self.test.nnz
