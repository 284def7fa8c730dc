"""Packaging for cymf-tpu (analogue of `/root/reference/setup.py`).

The native extension is optional: the package is fully functional without it
(pure-python fallbacks); `python setup.py build_ext --inplace` or
`make native` builds the C++ host-side kernels.
"""

import re
from pathlib import Path

from setuptools import Extension, find_packages, setup

init = Path(__file__).parent.joinpath("cymf_tpu/__init__.py").read_text()
version = re.search(r'__version__ = "([^"]+)"', init).group(1)

setup(
    name="cymf-tpu",
    version=version,
    description=("TPU-native matrix-factorization framework "
                 "(JAX/XLA/pjit/Pallas)"),
    packages=find_packages(exclude=("tests",)),
    # the PyTorch port builds its CUDA kernels and its native host prep
    # from these at first use
    package_data={"cymf_tpu_torch": ["csrc/*.cu", "csrc/*.cuh",
                                     "csrc/*.cpp"]},
    ext_modules=[
        Extension(
            "cymf_tpu.native._native",
            sources=["cymf_tpu/native/_native.cpp"],
            extra_compile_args=["-O3", "-std=c++17", "-fopenmp"],
            extra_link_args=["-fopenmp"],
            optional=True,
        ),
    ],
    install_requires=[
        "jax", "numpy", "scipy", "scikit-learn", "pandas", "tqdm",
    ],
    extras_require={"torch": ["torch"]},
    python_requires=">=3.10",
)
