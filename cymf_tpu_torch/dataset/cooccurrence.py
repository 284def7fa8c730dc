"""Co-occurrence dataset base.  Port of `cymf_tpu/dataset/cooccurrence.py`.

Concrete corpora (Text8) populate ``X`` (the sparse co-occurrence matrix)
and ``i2w`` with :func:`cymf_tpu_torch.dataset.text.read_text`.  The class
name keeps the reference's triple-r spelling (``CooccurrrenceDataset``)
for drop-in compatibility, with a correctly spelled alias.
"""

from __future__ import annotations

from typing import Dict, Union

from scipy import sparse

from .implicit import cache_root


class CooccurrrenceDataset:
    i2w: Dict[int, str]
    X: Union[sparse.csr_matrix, sparse.csc_matrix]

    def __init__(self, fname: str, min_count: int = 5, window_size: int = 10):
        self.root = cache_root()
        self.path = self.root / fname
        self.min_count = int(min_count)
        self.window_size = int(window_size)

    def vocab_size(self) -> int:
        raise NotImplementedError()


CooccurrenceDataset = CooccurrrenceDataset
