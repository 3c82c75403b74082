"""The port's sort on edge cases, its oracles and its boundary, on the CPU:
NaN, signed zeros, infinities, empty, one key, all-equal, one window and n
not a multiple of W against ``repro.ops`` (exact equality, with a payload);
``core.ref`` against ``repro.core.ref``; the port's own copy of the input
generators; what the entry points refuse; and no ``jax`` or ``repro``
import anywhere in the package, in ``chip_smoke.py`` or in the port's
examples (``examples/torch_*.py``).
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ref as ref_core_ref
from repro.data import distributions as ref_distributions
from repro_torch import ops
from repro_torch.core.ips4o import SortConfig, ips4o_sort
from repro_torch.core.ref import ref_partition, ref_sort
from repro_torch.data import distributions
from test_torch_sort import PORT_SMALL, REF_SMALL, check_sort
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


def _specials(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    x[::7] = np.nan
    x[1::11] = -0.0
    x[2::13] = 0.0
    x[3::17] = -np.inf
    x[4::19] = np.inf
    x[5::23] = np.float32(np.nan) * -1
    return x


@pytest.mark.parametrize(
    "x",
    [
        pytest.param(_specials(5000, 0), id="nan-signed-zero-inf"),
        pytest.param(_specials(20000, 1), id="nan-two-levels"),
        pytest.param(np.zeros(0, np.float32), id="empty"),
        pytest.param(np.array([2.5], np.float32), id="one"),
        pytest.param(np.full(3000, 7, np.int32), id="all-equal-int"),
        pytest.param(np.full(5000, -0.0, np.float32), id="all-negative-zero"),
        pytest.param(np.full(4500, np.nan, np.float32), id="all-nan"),
        pytest.param(np.arange(1023, -1, -1, dtype=np.int32), id="one-window"),
        pytest.param(np.arange(3001, dtype=np.int32) % 5, id="n-not-multiple-of-W"),
    ],
)
def test_edge_cases_match_reference(x):
    check_sort(x, REF_SMALL, PORT_SMALL, payload=True)


def test_ref_oracles_match_reference():
    rng = np.random.default_rng(4)
    keys = rng.integers(-20, 20, 3000).astype(np.int32)
    vals = rng.standard_normal(3000).astype(np.float32)
    want_k, want_v = ref_core_ref.ref_sort(jnp.asarray(keys), jnp.asarray(vals))
    got_k, got_v = ref_sort(torch.as_tensor(keys), torch.as_tensor(vals))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(ref_sort(torch.as_tensor(keys)).numpy(), np.asarray(want_k))
    ids = (keys + 20).astype(np.int32)
    want_out, want_off = ref_core_ref.ref_partition(jnp.asarray(ids), {"v": jnp.asarray(vals)},
                                                    40)
    got_out, got_off = ref_partition(torch.as_tensor(ids), {"v": torch.as_tensor(vals)}, 40)
    np.testing.assert_array_equal(got_out["v"].numpy(), np.asarray(want_out["v"]))
    np.testing.assert_array_equal(got_off.numpy(), np.asarray(want_off))


def test_distributions_copy_matches_reference():
    assert list(distributions.DISTRIBUTIONS) == list(ref_distributions.DISTRIBUTIONS)
    assert distributions.ELEMENT_TYPES == ref_distributions.ELEMENT_TYPES
    for name in distributions.DISTRIBUTIONS:
        for dtype in (np.float32, np.int32, np.float64, np.int16, np.uint8, np.uint64):
            for n in (0, 1, 1000):
                got = distributions.make_input(name, n, dtype, seed=3)
                want = ref_distributions.make_input(name, n, dtype, seed=3)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(distributions.make_payload(10, 3),
                                  ref_distributions.make_payload(10, 3))


def test_entry_points_refuse_what_is_not_ported(monkeypatch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.sort(torch.zeros(10, dtype=torch.complex64), device="cpu")
    with pytest.raises(ValueError, match="batched_argsort"):
        ops.argsort(torch.zeros((2, 10)), device="cpu")
    # the learned classifier and payload pytrees are ported; what stays
    # refused: an engine (the port has none), unknown classifiers, and
    # payload leaves whose leading dim is not the keys'
    with pytest.raises(ValueError, match="engine"):
        ops.with_engine(SortConfig(), "pallas")
    with pytest.raises(ValueError, match="classifier"):
        ops.sort(torch.zeros(10), cfg=dataclasses.replace(SortConfig(), classifier="neural"),
                 device="cpu")
    with pytest.raises(ValueError, match="leading dims"):
        ips4o_sort(torch.zeros(10, dtype=torch.int32), {"v": torch.zeros(9)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.sort(torch.zeros(10))


def test_port_imports_no_jax_or_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.ops, repro_torch.core.ips4o\n"
        "import repro_torch.kernels.level_fused, repro_torch.kernels.bitonic\n"
        "import repro_torch.ops.batched, repro_torch.ops.topk, repro_torch.classify.radix\n"
        "import repro_torch.data.distributions, repro_torch.data.datasets\n"
        "import repro_torch.ops.plan, repro_torch.classify.learned, repro_torch.classify.router\n"
        "import repro_torch.stream\n"
        "import repro_torch.configs, repro_torch.serve, repro_torch.models.convert\n"
        "import repro_torch.kernels.flash_decode, repro_torch.kernels.flash_attention\n"
        "import repro_torch.optim, repro_torch.train, repro_torch.launch.train\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_jax_or_reference_import_in_port_sources():
    files = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "examples").glob("torch_*.py")))
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"
