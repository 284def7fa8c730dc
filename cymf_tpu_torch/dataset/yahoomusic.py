"""Yahoo! R3 loader.  Port of `cymf_tpu/dataset/yahoomusic.py`, reading
and splitting with numpy alone.

The protocol of the JAX package (and of the reference's
`yahoomusic.py:29-48`): the R3 train/test TSVs have 1-based user/item ids
and explicit ratings; ids are shifted to 0-based, ratings >=
``min_rating`` are kept and binarized to 1.0, user/item counts come from
the train file, and the validation split is 90/10 of train with
``random_state=12345`` (:func:`~.implicit.holdout_split`).

R3 is downloaded by hand from the Yahoo Webscope program: when the
directory is absent, the instructions are printed and
``FileNotFoundError`` raised.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .implicit import ImplicitFeedbackDataset, Ratings, holdout_split
from .movielens import read_table

_FILES = {
    "train": "ydata-ymusic-rating-study-v1_0-train.txt",
    "test": "ydata-ymusic-rating-study-v1_0-test.txt",
}


class YahooMusic(ImplicitFeedbackDataset):
    def __init__(self, min_rating: float = 4.0,
                 under_sampling: Optional[int] = None):
        """``under_sampling`` is accepted and ignored, as in the JAX
        package."""
        super().__init__("yahoomusic", min_rating)

        if not self.dir_path.exists():
            msg = (
                "download R3 dataset from "
                "https://webscope.sandbox.yahoo.com/catalog.php?datatype=r , "
                f"and put it on {self.dir_path.as_posix()}.")
            print(msg)
            raise FileNotFoundError(msg)

        train = self._read(_FILES["train"], min_rating)
        self._test = self._read(_FILES["test"], min_rating)

        self.num_user = int(train.user.max()) + 1
        self.num_item = int(train.item.max()) + 1

        tr, va = holdout_split(np.arange(len(train.user)))
        self._train, self._valid = train.take(tr), train.take(va)

        self.train = self.to_matrix(self._train)
        self.valid = self.to_matrix(self._valid)
        self.test = self.to_matrix(self._test)
        self._finalize()

    @property
    def df_train(self):
        """The train rows as a pandas frame (imports pandas)."""
        return self._train.to_frame()

    @property
    def df_valid(self):
        return self._valid.to_frame()

    @property
    def df_test(self):
        return self._test.to_frame()

    def _read(self, fname: str, min_rating: float) -> Ratings:
        """TSV -> 0-based ids, >= min_rating kept and binarized."""
        t = read_table(self.dir_path / fname, b"\t", 3)
        keep = np.flatnonzero(t[:, 2] >= min_rating)
        return Ratings(t[keep, 0].astype(np.int64) - 1,
                       t[keep, 1].astype(np.int64) - 1,
                       np.ones(len(keep), np.float64), keep)
