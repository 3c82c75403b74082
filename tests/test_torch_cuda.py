"""The port's CUDA kernels against their plain twins, on a CUDA card.

Marked ``gpu``: every test skips (from its fixture) where no card is
present, so the CPU suite collects the same tests on every worker.  On the
card: ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py``.
Tolerance: exact equality (integer outputs).
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels, ops
from repro_torch.core import sampling
from repro_torch.data.distributions import make_input
from repro_torch.kernels import bitonic, level_fused as lf

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU suite runs the plain twins")
    return torch.device("cuda", 0)


def _equal(got, want):
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("k,n,n_real,tile", [(2, 1000, 1000, 256), (128, 70000, 65537, 4096)])
def test_level_fused_kernel(dev, k, n, n_real, tile):
    keys = ops.keyspace.encode(torch.as_tensor(make_input("TwoDup", n, np.int32), device=dev))
    spl = sampling.select_splitters(torch.sort(keys[:n_real][:512]).values, k)
    before = kernels.launch_counts()["level_fused"]
    _equal(lf.level_fused(keys, spl, k=k, n_real=n_real, tile=tile),
           lf.level_fused_plain(keys, spl, k=k, n_real=n_real, tile=tile))
    assert kernels.launch_counts()["level_fused"] == before + 1


@pytest.mark.parametrize("nb,seg", [(3, 0), (520, 0), (40 * 256, 40)])
def test_rank_hist_kernel(dev, nb, seg):
    g = torch.Generator(device=dev).manual_seed(nb)
    n = 50000
    if seg:
        off = torch.sort(torch.randint(0, n + 1, (seg + 1,), generator=g, device=dev)).values
        off[0], off[-1] = 0, n
        off = off.to(torch.int32)
        s = torch.searchsorted(off, torch.arange(n, device=dev, dtype=torch.int32), right=True) - 1
        ids = (s * 256 + torch.randint(0, 256, (n,), generator=g, device=dev)).to(torch.int32)
        kw = dict(nb=nb, seg_offsets=off, seg_width=256)
    else:
        ids = torch.randint(0, nb, (n,), generator=g, device=dev, dtype=torch.int32)
        kw = dict(nb=nb)
    _equal(lf.rank_hist(ids, **kw), lf.rank_hist_plain(ids, **kw))


@pytest.mark.parametrize("W", [2, 1024, 8192])
def test_sort_windows_kernel(dev, W):
    g = torch.Generator(device=dev).manual_seed(W)
    b = torch.sort(torch.randint(0, 9, (5, W), generator=g, device=dev,
                                 dtype=torch.int32), dim=1).values
    k = torch.randint(-3, 4, (5, W), generator=g, device=dev, dtype=torch.int32)
    _equal(bitonic.sort_windows(b, k, nb=9), bitonic.sort_windows_plain(b, k, nb=9))


@pytest.mark.parametrize("n", [1, 5000, 300_000])
def test_sort_on_the_card_matches_the_cpu(dev, n):
    x = make_input("Exponential", n, np.float32, seed=1)
    x[::31] = np.nan
    got = ops.argsort(torch.as_tensor(x)).cpu()
    want = ops.argsort(torch.as_tensor(x), device="cpu")
    assert torch.equal(got, want)
    assert torch.equal(ops.sort(torch.as_tensor(x)).cpu().view(torch.int32),
                       ops.sort(torch.as_tensor(x), device="cpu").view(torch.int32))
