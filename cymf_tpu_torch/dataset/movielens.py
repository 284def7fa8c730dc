"""MovieLens loader.  Port of `cymf_tpu/dataset/movielens.py`, reading and
splitting with numpy alone (no pandas, no scikit-learn).

The split protocol of the JAX package (and of the reference's
`movielens.py:62-66`), reproduced exactly:

* dense id remap of raw user/item ids, ids in the iteration order of
  ``set(column)`` (:meth:`MovieLens.reset_id`);
* keep ratings >= ``min_rating`` (default 4.0), binarize to 1.0;
* 90/10 train/test split then 90/10 train/valid split, both
  ``train_test_split(test_size=0.1, random_state=12345)``
  (:func:`~.implicit.holdout_split`).

The three file formats: ml-100k's tab-separated ``u.data``, ml-1m's and
ml-10m's ``ratings.dat`` (``::``-separated), ml-20m's and ml-25m's
``ratings.csv`` (a header row, half-star float ratings).  A file absent
from the cache is downloaded from grouplens with urllib; a pre-downloaded
zip or extracted directory under the cache root (or the reference's
``~/.cymf``) is used as it is, so machines without a network can be
provisioned by hand.
"""

from __future__ import annotations

import zipfile
from pathlib import Path
from typing import Optional

import numpy as np

from .implicit import ImplicitFeedbackDataset, Ratings, holdout_split

NAMES = ("ml-100k", "ml-1m", "ml-10m", "ml-20m", "ml-25m")


def _download(url: str, out: Path) -> None:
    import urllib.request
    print(f"downloading {url} ...")
    urllib.request.urlretrieve(url, str(out))


def read_table(path: Path, sep: bytes, ncols: int,
               header: bool = False) -> np.ndarray:
    """A numeric text table -> float64 ``(rows, ncols)``: each line holds
    ``ncols`` numbers separated by ``sep``; ``header`` skips the first
    line.  Raises ``ValueError`` on a line of another width."""
    raw = Path(path).read_bytes()
    if header:
        raw = raw[raw.find(b"\n") + 1:] if b"\n" in raw else b""
    body = raw.strip()
    nlines = body.count(b"\n") + 1 if body else 0
    if sep.strip():
        body = body.replace(sep, b" ")
    vals = np.fromstring(body, dtype=np.float64, sep=" ") if body \
        else np.zeros(0)
    if vals.size != nlines * ncols:
        raise ValueError(f"{path}: expected {ncols} numbers on each of "
                         f"{nlines} lines, read {vals.size}")
    return vals.reshape(nlines, ncols)


class MovieLens(ImplicitFeedbackDataset):
    def __init__(self, dir_name: str = "ml-100k", min_rating: float = 4.0,
                 under_sampling: Optional[int] = None):
        """``under_sampling`` is accepted and ignored, as in the JAX
        package."""
        super().__init__(dir_name, min_rating)

        if dir_name not in NAMES:
            raise ValueError(
                "dir_name must be one of 'ml-100k', 'ml-1m', 'ml-10m', "
                "'ml-20m', 'ml-25m'.")

        self._ensure_files(dir_name)
        print("loading movielens...")
        t = self._read_ratings(dir_name)
        user = self.reset_id(t[:, 0].astype(np.int64))
        item = self.reset_id(t[:, 1].astype(np.int64))
        self.num_user = int(user.max(initial=-1)) + 1
        self.num_item = int(item.max(initial=-1)) + 1

        keep = np.flatnonzero(t[:, 2] >= self.min_rating)
        rows = Ratings(user[keep], item[keep],
                       np.ones(len(keep), np.float64), keep,
                       t[keep, 3].astype(np.int64))

        tr, te = holdout_split(np.arange(len(keep)))
        tr, va = holdout_split(tr)
        self._train, self._valid, self._test = (rows.take(tr),
                                                rows.take(va),
                                                rows.take(te))
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

    # -- files ---------------------------------------------------------------
    def _ensure_files(self, dir_name: str) -> None:
        if self.dir_path.exists():
            return
        # also accept the reference's cache dir for shared provisioning
        legacy = Path.home().joinpath(".cymf", dir_name)
        if legacy.exists():
            self.dir_path = legacy
            return
        zip_path = self.dir_path.parent.joinpath(dir_name + ".zip")
        if not zip_path.exists():
            print("movielens file does not exist, downloading ...")
            _download(
                f"http://files.grouplens.org/datasets/movielens/{dir_name}.zip",
                zip_path)
        with zipfile.ZipFile(zip_path) as zf:
            zf.extractall(self.dir_path.parent)
        # ml-10m extracts as "ml-10M100K"
        if dir_name == "ml-10m" and not self.dir_path.exists():
            extracted = self.dir_path.parent.joinpath("ml-10M100K")
            if extracted.exists():
                extracted.rename(self.dir_path)

    def _read_ratings(self, dir_name: str) -> np.ndarray:
        """``(rows, 4)`` float64: user, item, rating, timestamp."""
        if dir_name == "ml-100k":
            return read_table(self.dir_path / "u.data", b"\t", 4)
        if dir_name in ("ml-1m", "ml-10m"):
            return read_table(self.dir_path / "ratings.dat", b"::", 4)
        # ml-20m / ml-25m ship a CSV with a header row
        return read_table(self.dir_path / "ratings.csv", b",", 4,
                          header=True)

    @staticmethod
    def reset_id(column: np.ndarray) -> np.ndarray:
        """Dense id remap (`movielens.py:76-85` of the reference): ids in
        the iteration order of ``set(column)`` over Python ints inserted in
        row order, as the JAX package builds it.  Only each id's first
        occurrence changes the set, so the set is built from those, and the
        map is applied vectorised."""
        column = np.asarray(column, np.int64)
        uniq, first = np.unique(column, return_index=True)
        order = list(set(uniq[np.argsort(first, kind="stable")].tolist()))
        ids = np.empty(len(uniq), np.int64)
        # uniq is sorted: the position of each set member in it
        ids[np.searchsorted(uniq, np.asarray(order, np.int64))] = \
            np.arange(len(order))
        return ids[np.searchsorted(uniq, column)]
