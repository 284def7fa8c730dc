"""Implicit-feedback dataset base: the attribute contract of
`cymf_tpu/dataset/implicit.py`.  The pandas helpers and the cache root
belong to the file-backed loaders, which are not ported yet."""

from __future__ import annotations

from scipy import sparse


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

    def _finalize(self):
        self.train_size = self.train.nnz
        self.valid_size = self.valid.nnz
        self.test_size = self.test.nnz
