"""The port's public namespaces hold the JAX package's names.

For each of the nine namespaces, every name of the JAX one's ``__all__``
(or, where it has none, every public name it defines) must be in the
port's ``__all__`` (or its public names) and importable, with no
allowance.  Importing ``cymf_tpu_torch.ops`` builds and loads no kernel.
"""

import importlib
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
NAMESPACES = ["", ".utils", ".ops", ".dataset", ".evaluation", ".models",
              ".optim", ".parallel", ".config"]
# names the port may lack, by namespace: none
ALLOWED_MISSING: dict = {}


def _public(mod) -> set:
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {n for n, v in vars(mod).items() if not n.startswith("_")
            and getattr(v, "__module__", None) == mod.__name__}


@pytest.mark.parametrize("ns", NAMESPACES)
def test_port_exports_jax_names(ns):
    jax_mod = importlib.import_module("cymf_tpu" + ns)
    port = importlib.import_module("cymf_tpu_torch" + ns)
    want = _public(jax_mod)
    assert want, ns
    allowed = ALLOWED_MISSING.get(ns, set())
    missing = want - _public(port) - allowed
    assert not missing, (ns, sorted(missing))
    for name in want - allowed:
        assert hasattr(port, name), (ns, name)
    # the allowance lists only what is really missing
    assert not allowed & _public(port), (ns, allowed & _public(port))


def test_named_imports_work():
    from cymf_tpu_torch.ops import (als, csr_contains, csr_lookup,  # noqa
                                    dedup_rows)
    from cymf_tpu_torch.utils import (AsyncCheckpointer,  # noqa
                                      load_checkpoint, save_checkpoint)
    from cymf_tpu_torch.utils import checkpoint
    assert save_checkpoint is checkpoint.save_checkpoint
    assert callable(als.solve_spd_dense)


def test_importing_ops_loads_no_kernel():
    code = (
        "import cymf_tpu_torch\n"
        "import cymf_tpu_torch.ops as ops\n"
        "from cymf_tpu_torch.ops import als, dedup_rows, csr_lookup\n"
        "from cymf_tpu_torch.ops import _kernels\n"
        "print(_kernels._lib is None, dict(_kernels.launches))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "True {}"
