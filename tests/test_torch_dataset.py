"""The port's file-backed datasets against the JAX package's loaders.

Every file is written under a temporary ``HOME`` and cache root, in the
formats of MovieLens (ml-100k's ``u.data``, ml-1m's ``ratings.dat``,
ml-20m's ``ratings.csv`` with its header and half stars), Yahoo! R3 and
text8, and ``urllib.request.urlretrieve`` raises: nothing is downloaded.
The loaders' matrices, counts and frames must equal the JAX ones exactly;
``read_text``'s vocabulary and sparsity pattern exactly, its values within
a relative 1e-12 (the native library sums in its own order).
"""

import os
import subprocess
import sys
import urllib.request
import zipfile
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.model_selection import train_test_split

import cymf_tpu.dataset as jd
import cymf_tpu_torch.dataset as td
from cymf_tpu.dataset.implicit import ImplicitFeedbackDataset as JBase
from cymf_tpu_torch import native
from cymf_tpu_torch.dataset import implicit as timp
from cymf_tpu_torch.dataset import text as ttext

ROOT = Path(__file__).resolve().parents[1]
YAHOO = ("ydata-ymusic-rating-study-v1_0-train.txt",
         "ydata-ymusic-rating-study-v1_0-test.txt")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test (the suite runs in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def home(tmp_path, monkeypatch):
    """A temporary ``HOME`` (the default cache root lies under it), no
    ``CYMF_TPU_CACHE``, and no network."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("CYMF_TPU_CACHE", raising=False)

    def refuse(url, *a, **k):
        raise ConnectionRefusedError(f"no download in tests: {url}")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    return tmp_path


def _ratings(n, n_user, n_item, seed, half_stars=False):
    """Seeded rating rows over sparse raw ids (large movie ids, so the
    id sets' iteration order has collisions), duplicates included."""
    rng = np.random.default_rng(seed)
    users = rng.choice(np.arange(1, 3 * n_user), n_user, replace=False)
    items = rng.choice(np.arange(1, 200_000), n_item, replace=False)
    u = rng.choice(users, n)
    i = rng.choice(items, n)
    r = rng.integers(1, 11, n) / 2 if half_stars else rng.integers(1, 6, n)
    ts = rng.integers(800_000_000, 1_500_000_000, n)
    return u, i, r, ts


def _write_movielens(base: Path, name: str, n=3000, seed=0):
    d = base / name
    d.mkdir(parents=True)
    if name == "ml-100k":
        u, i, r, ts = _ratings(n, 90, 70, seed)
        text = "\n".join(f"{a}\t{b}\t{c}\t{e}" for a, b, c, e in
                         zip(u, i, r, ts))
        (d / "u.data").write_text(text)          # no final newline
    elif name in ("ml-1m", "ml-10m"):
        u, i, r, ts = _ratings(n, 120, 90, seed)
        text = "\n".join(f"{a}::{b}::{c}::{e}" for a, b, c, e in
                         zip(u, i, r, ts))
        (d / "ratings.dat").write_text(text + "\n")
    else:
        u, i, r, ts = _ratings(n, 150, 110, seed, half_stars=True)
        text = "\n".join(f"{a},{b},{c:.1f},{e}" for a, b, c, e in
                         zip(u, i, r, ts))
        (d / "ratings.csv").write_text(
            "userId,movieId,rating,timestamp\n" + text + "\n")
    return d


def _same_matrices(a, b):
    assert (a.num_user, a.num_item) == (b.num_user, b.num_item)
    for m in ("train", "valid", "test"):
        x, y = getattr(a, m).tocsr(), getattr(b, m).tocsr()
        assert x.shape == y.shape == (a.num_user, a.num_item), m
        assert x.nnz == y.nnz and (x != y).nnz == 0, m
        assert x.dtype == y.dtype, m
    assert (a.train_size, a.valid_size, a.test_size) == \
        (b.train_size, b.valid_size, b.test_size)


@pytest.mark.parametrize("name,min_rating", [
    ("ml-100k", 4.0), ("ml-1m", 4.0), ("ml-10m", 3.0), ("ml-20m", 4.0),
    ("ml-25m", 3.5)])
def test_movielens_matches_jax(home, name, min_rating):
    _write_movielens(home / ".cymf_tpu", name)
    got = td.MovieLens(name, min_rating=min_rating)
    want = jd.MovieLens(name, min_rating=min_rating)
    _same_matrices(got, want)
    assert got.dir_path == want.dir_path
    for part in ("df_train", "df_valid", "df_test"):
        pd.testing.assert_frame_equal(getattr(got, part),
                                      getattr(want, part))


def test_movielens_reset_id_matches_set_order():
    rng = np.random.default_rng(5)
    col = rng.choice(rng.choice(10**6, 3000, replace=False), 20000)
    s = pd.Series(col)
    want = jd.MovieLens.reset_id(None, s).to_numpy()
    np.testing.assert_array_equal(td.MovieLens.reset_id(col), want)


def test_movielens_cache_override_and_legacy_dir(home, monkeypatch):
    # CYMF_TPU_CACHE points both packages at another root
    cache = home / "elsewhere"
    _write_movielens(cache, "ml-100k", seed=1)
    monkeypatch.setenv("CYMF_TPU_CACHE", str(cache))
    _same_matrices(td.MovieLens(), jd.MovieLens())
    assert td.MovieLens().dir_path == cache / "ml-100k"
    # the reference's ~/.cymf/<name> directory when the cache lacks it
    _write_movielens(home / ".cymf", "ml-1m", seed=2)
    got = td.MovieLens("ml-1m")
    assert got.dir_path == home / ".cymf" / "ml-1m"
    _same_matrices(got, jd.MovieLens("ml-1m"))


def test_movielens_zip_extraction_renames_ml10m(home):
    src = _write_movielens(home / "src", "ml-10m", seed=3)
    cache = home / ".cymf_tpu"
    cache.mkdir()
    with zipfile.ZipFile(cache / "ml-10m.zip", "w") as zf:
        zf.write(src / "ratings.dat", "ml-10M100K/ratings.dat")
    got = td.MovieLens("ml-10m")
    assert (cache / "ml-10m" / "ratings.dat").exists()
    assert not (cache / "ml-10M100K").exists()
    _same_matrices(got, jd.MovieLens("ml-10m"))


def test_movielens_errors(home):
    with pytest.raises(ValueError, match="dir_name must be one of"):
        td.MovieLens("ml-10b")
    # an absent file goes to urllib, which the fixture refuses
    with pytest.raises(ConnectionRefusedError, match="ml-100k.zip"):
        td.MovieLens("ml-100k")
    d = home / ".cymf_tpu" / "ml-1m"
    d.mkdir(parents=True)
    (d / "ratings.dat").write_text("1::2::5::0\n3::4::5\n")
    with pytest.raises(ValueError, match="expected 4 numbers"):
        td.MovieLens("ml-1m")


def test_movielens_under_sampling_ignored(home):
    _write_movielens(home / ".cymf_tpu", "ml-100k", seed=4)
    _same_matrices(td.MovieLens(under_sampling=10), td.MovieLens())


def _bases():
    t = timp.ImplicitFeedbackDataset.__new__(timp.ImplicitFeedbackDataset)
    j = JBase.__new__(JBase)
    for d in (t, j):
        d.num_user, d.num_item = 7, 5
    return t, j


def test_to_matrix_keeps_last_duplicate():
    t, j = _bases()
    rng = np.random.default_rng(2)
    df = pd.DataFrame({"user": rng.integers(0, 7, 60),
                       "item": rng.integers(0, 5, 60),
                       "rating": rng.integers(1, 6, 60).astype(float)})
    want = j.to_matrix(df)
    for rows in (df, timp.Ratings(df.user.to_numpy(), df.item.to_numpy(),
                                  df.rating.to_numpy(),
                                  np.arange(len(df)))):
        got = t.to_matrix(rows)
        assert isinstance(got, type(want))
        np.testing.assert_array_equal(got.toarray(), want.toarray())
        assert got.nnz == want.nnz
    small = pd.DataFrame({"user": [0, 0], "item": [1, 1],
                          "rating": [2.0, 5.0]})
    assert t.to_matrix(small)[0, 1] == 5.0


def test_to_dataframe_and_split_match_jax():
    from scipy import sparse
    t, j = _bases()
    m = sparse.lil_matrix((7, 5))
    m[0, 1], m[2, 4], m[6, 0] = 5.0, 3.0, -1.0
    got, want = t.to_dataframe(m), j.to_dataframe(m)
    pd.testing.assert_frame_equal(got, want)
    assert len(got) == 34                 # rating >= 0 keeps zero cells
    for a, b in zip(t.split(got), j.split(want)):
        np.testing.assert_array_equal(a, b)
    assert t.split(got)[2].shape == (34, 1)


@pytest.mark.parametrize("n", [10, 11, 99, 1000, 12345])
def test_holdout_split_is_sklearns(n):
    idx = np.arange(n) * 3 + 1
    for got, want in zip(timp.holdout_split(idx),
                         train_test_split(idx, test_size=0.1,
                                          random_state=12345)):
        np.testing.assert_array_equal(got, want)
    from cymf_tpu_torch.dataset import synthetic
    assert synthetic.holdout_split is timp.holdout_split


def _write_yahoo(d: Path, seed=0):
    d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for fname, n in zip(YAHOO, (1500, 300)):
        rows = zip(rng.integers(1, 51, n), rng.integers(1, 31, n),
                   rng.integers(1, 6, n))
        (d / fname).write_text("\n".join(f"{a}\t{b}\t{c}" for a, b, c
                                         in rows))


@pytest.mark.parametrize("min_rating", [4.0, 2.0])
def test_yahoomusic_matches_jax(home, min_rating):
    _write_yahoo(home / ".cymf_tpu" / "yahoomusic")
    got = td.YahooMusic(min_rating=min_rating)
    want = jd.YahooMusic(min_rating=min_rating)
    _same_matrices(got, want)
    for part in ("df_train", "df_valid", "df_test"):
        g, w = getattr(got, part), getattr(want, part)
        pd.testing.assert_frame_equal(g, w[["user", "item", "rating"]],
                                      check_dtype=False)
    assert got.train.tocsr().data.min() == 1.0


def test_yahoomusic_missing_raises(home):
    with pytest.raises(FileNotFoundError, match="webscope") as got:
        td.YahooMusic()
    with pytest.raises(FileNotFoundError) as want:
        jd.YahooMusic()
    assert str(got.value) == str(want.value)


def _corpus(path: Path, n_tokens=60_000, vocab=3000, seed=0):
    rng = np.random.default_rng(seed)
    words = np.array([f"w{k}" for k in range(vocab)])
    toks = words[np.minimum(rng.zipf(1.2, n_tokens) - 1, vocab - 1)]
    cuts = np.sort(rng.choice(n_tokens, n_tokens // 300, replace=False))
    lines = [" ".join(part) for part in np.split(toks, cuts)]
    path.write_text("\n".join(lines))
    return path


def _same_cooccurrence(got, want):
    (X, i2w), (Y, j2w) = got, want
    assert i2w == j2w
    assert X.shape == Y.shape
    X, Y = X.tocsr(), Y.tocsr()
    X.sort_indices()
    Y.sort_indices()
    np.testing.assert_array_equal(X.indptr, Y.indptr)
    np.testing.assert_array_equal(X.indices, Y.indices)
    np.testing.assert_allclose(X.data, Y.data, rtol=1e-12, atol=0)


@pytest.mark.parametrize("min_count,window", [(5, 10), (1, 3), (20, 1)])
def test_read_text_matches_jax(tmp_path, min_count, window):
    f = _corpus(tmp_path / "corpus.txt")
    _same_cooccurrence(td.read_text(str(f), min_count, window),
                       jd.read_text(str(f), min_count, window))


def test_native_cooccurrence_matches_python_form():
    rng = np.random.default_rng(3)
    lines = [list(rng.integers(0, 40, rng.integers(0, 30)))
             for _ in range(200)] + [[], [7], [1, 1, 1]]
    keys, vals = ttext._native_cooccurrence(lines, 40, 4)
    pk, pv = ttext._python_cooccurrence(lines, 40, 4)
    order = np.argsort(keys)
    np.testing.assert_array_equal(keys[order], pk)
    np.testing.assert_allclose(vals[order], pv, rtol=1e-12, atol=0)


def test_read_text_raises_without_native(tmp_path, monkeypatch):
    f = _corpus(tmp_path / "corpus.txt", n_tokens=2000)

    def broken():
        raise RuntimeError("native library failed to build")

    monkeypatch.setattr(native, "lib", broken)
    with pytest.raises(RuntimeError, match="failed to build"):
        td.read_text(str(f))


@pytest.mark.parametrize("lang,fname", [("en", "text8"), ("ja", "ja.text8")])
def test_text8_from_provisioned_file(home, lang, fname):
    cache = home / ".cymf_tpu"
    cache.mkdir()
    _corpus(cache / fname, n_tokens=20_000)
    got = td.Text8(lang, min_count=3, window_size=5)
    assert got.path == cache / fname
    assert got.vocab_size() == len(got.i2w)
    want = jd.Text8(lang, min_count=3, window_size=5)
    _same_cooccurrence((got.X, got.i2w), (want.X, want.i2w))
    assert isinstance(got, td.CooccurrenceDataset)
    assert td.CooccurrenceDataset is td.CooccurrrenceDataset


def test_text8_zip_legacy_and_errors(home):
    with pytest.raises(ValueError, match="'en' or 'ja'"):
        td.Text8("fr")
    with pytest.raises(ConnectionRefusedError, match="text8.zip"):
        td.Text8()
    src = _corpus(home / "text8", n_tokens=5000)
    with zipfile.ZipFile(home / ".cymf_tpu" / "text8.zip", "w") as zf:
        zf.write(src, "text8")
    got = td.Text8(min_count=2)
    assert got.path.exists() and got.vocab_size() > 0
    legacy = home / ".cymf"
    legacy.mkdir()
    _corpus(legacy / "ja.text8", n_tokens=5000, seed=4)
    got = td.Text8("ja", min_count=2)
    assert got.path == legacy / "ja.text8"
    want = jd.Text8("ja", min_count=2)
    _same_cooccurrence((got.X, got.i2w), (want.X, want.i2w))


def test_cooccurrence_base_matches_jax(home):
    got = td.CooccurrrenceDataset("corpus", min_count=3, window_size=4)
    want = jd.CooccurrrenceDataset("corpus", min_count=3, window_size=4)
    assert (got.path, got.min_count, got.window_size) == \
        (want.path, want.min_count, want.window_size)
    with pytest.raises(NotImplementedError):
        got.vocab_size()


def test_loading_movielens_imports_no_pandas_or_sklearn(home):
    _write_movielens(home / ".cymf_tpu", "ml-100k", seed=6)
    code = (
        "import sys\n"
        "from cymf_tpu_torch.dataset import MovieLens, read_text\n"
        "m = MovieLens('ml-100k')\n"
        "assert m.train.nnz > 0\n"
        "print(sorted({k.split('.')[0] for k in sys.modules} & "
        "{'pandas', 'sklearn', 'jax', 'tqdm', 'cymf_tpu'}))\n")
    env = dict(os.environ, HOME=str(home), PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # torch may import tqdm where it is installed; the loaders add none
    assert set(eval(out.stdout.strip().splitlines()[-1])) <= {"tqdm"}
