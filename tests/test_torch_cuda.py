"""The port's CUDA kernels against their plain twins, on a CUDA card:
K1 (tree), K1r (radix), K4 ``level_fused_batched`` (both modes),
K2 ``rank_hist``, K4 ``rank_hist_batched`` and K3, and the sorts on the
card against the same sorts on the CPU.

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


@pytest.mark.parametrize("k,n,n_real,consumed", [(2, 1000, 1000, 0), (128, 70000, 65537, 0),
                                                  (16, 9000, 8000, 3)])
def test_level_fused_radix_kernel(dev, k, n, n_real, consumed):
    keys = torch.randint(-2**31, 2**31 - 1, (n,), device=dev, dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(k))
    keys[::97] = torch.iinfo(torch.int32).max  # the sentinel: an equality bucket
    kw = dict(k=k, n_real=n_real, classifier="radix", consumed_bits=consumed)
    before = kernels.launch_counts()["level_fused_radix"]
    _equal(lf.level_fused(keys, **kw), lf.level_fused_plain(keys, **kw))
    assert kernels.launch_counts()["level_fused_radix"] == before + 1


@pytest.mark.parametrize("classifier", ["tree", "radix"])
@pytest.mark.parametrize("B,n,n_real,k,tile", [(1, 1000, 1000, 2, 256), (5, 20000, 19000, 64, 4096),
                                               (64, 4096, 4000, 128, 1024)])
def test_level_fused_batched_kernel(dev, classifier, B, n, n_real, k, tile):
    x = make_input("TwoDup", B * n, np.int32, seed=B).reshape(B, n)
    keys = ops.keyspace.encode(torch.as_tensor(x, device=dev))
    spl = None
    if classifier == "tree":
        spl = sampling.select_splitters(torch.sort(keys[:, :256], dim=1).values, k)
    kw = dict(k=k, n_real=n_real, tile=tile, classifier=classifier)
    before = kernels.launch_counts()["level_fused_batched"]
    _equal(lf.level_fused_batched(keys, spl, **kw), lf.level_fused_batched_plain(keys, spl, **kw))
    assert kernels.launch_counts()["level_fused_batched"] == before + 1


@pytest.mark.parametrize("B,n,num_seg,width", [(3, 5000, 0, 40), (8, 30000, 17, 256)])
def test_rank_hist_batched_kernel(dev, B, n, num_seg, width):
    g = torch.Generator(device=dev).manual_seed(n)
    if num_seg:
        off = torch.sort(torch.randint(0, n + 1, (B, num_seg + 1), generator=g, device=dev),
                         dim=1).values
        off[:, 0], off[:, -1] = 0, n
        off = off.to(torch.int32)
        pos = torch.arange(n, device=dev, dtype=torch.int32).expand(B, n).contiguous()
        s = torch.searchsorted(off, pos, right=True) - 1
        ids = (s * width + torch.randint(0, width, (B, n), generator=g, device=dev)).to(
            torch.int32)
        kw = dict(nb=num_seg * width, seg_offsets=off, seg_width=width)
    else:
        ids = torch.randint(0, width, (B, n), generator=g, device=dev, dtype=torch.int32)
        kw = dict(nb=width)
    before = kernels.launch_counts()["rank_hist_batched"]
    _equal(lf.rank_hist_batched(ids, **kw), lf.rank_hist_batched_plain(ids, **kw))
    assert kernels.launch_counts()["rank_hist_batched"] == before + 1


@pytest.mark.parametrize("classifier", ["tree", "radix"])
@pytest.mark.parametrize("B,n", [(3, 5000), (4, 300_000)])
def test_batched_sort_on_the_card_matches_the_cpu(dev, classifier, B, n):
    x = make_input("Uniform", B * n, np.float32, seed=2).reshape(B, n)
    x[:, ::29] = np.nan
    got = ops.batched_argsort(torch.as_tensor(x), classifier=classifier).cpu()
    want = ops.batched_argsort(torch.as_tensor(x), classifier=classifier, device="cpu")
    assert torch.equal(got, want)
    v, i = ops.batched_topk(torch.as_tensor(x), 64, classifier=classifier)
    wv, wi = ops.batched_topk(torch.as_tensor(x), 64, classifier=classifier, device="cpu")
    assert torch.equal(v.cpu().view(torch.int32), wv.view(torch.int32))
    assert torch.equal(i.cpu(), wi)
