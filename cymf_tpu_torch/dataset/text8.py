"""Text8 corpus loader.  Port of `cymf_tpu/dataset/text8.py`.

en (mattmahoney text8) and ja (chakki ja.text8) variants; downloaded and
unzipped when absent (a provisioned file under the cache root, or the
reference's ``~/.cymf``, is used as it is), then the co-occurrence matrix
is built by :func:`cymf_tpu_torch.dataset.text.read_text`.
"""

from __future__ import annotations

import zipfile
from pathlib import Path

from .cooccurrence import CooccurrrenceDataset
from .text import read_text

_URLS = {
    "en": "http://mattmahoney.net/dc/text8.zip",
    "ja": ("https://s3-ap-northeast-1.amazonaws.com/dev.tech-sketch.jp/"
           "chakki/public/ja.text8.zip"),
}


class Text8(CooccurrrenceDataset):
    def __init__(self, lang: str = "en", min_count: int = 5,
                 window_size: int = 10):
        if lang == "en":
            fname = "text8"
        elif lang == "ja":
            fname = "ja.text8"
        else:
            raise ValueError("An argument 'lang' must be 'en' or 'ja'.")

        super().__init__(fname, min_count, window_size)

        if not self.path.exists():
            # accept the reference's cache dir too
            legacy = Path.home().joinpath(".cymf", fname)
            if legacy.exists():
                self.path = legacy
            else:
                zip_path = self.path.parent.joinpath(self.path.name + ".zip")
                if not zip_path.exists():
                    import urllib.request
                    print(f"downloading {_URLS[lang]} ...")
                    urllib.request.urlretrieve(_URLS[lang], str(zip_path))
                with zipfile.ZipFile(zip_path) as zf:
                    zf.extractall(self.path.parent)

        self.X, self.i2w = read_text(str(self.path), self.min_count,
                                     self.window_size)

    def vocab_size(self):
        return len(self.i2w)
