"""Parity of the port's sort ops with the reference's on every key dtype.

The keys of 32 bits or fewer (int8, uint8, int16, uint16, float16,
bfloat16, uint32; float32 and int32 have their own files) run in this
process: ``sort``, ``argsort``, ``topk``, ``bottomk``, the ``batched_*``
ops, ``segmented_sort``, ``group_by`` and ``unique``, with both
classifiers, at n = 3000 and ``SortConfig(base_case=512, kmax=8,
tile=256)``, so that two levels and the robustness fallback run.  Level 1's
radix bucket ids of the 8- and 16-bit keys equal the reference's
``classify.radix`` ids.  The 64-bit keys (int64, uint64, float64) need
jax's x64 mode from startup, so they run in one child process (the
reference's idiom, ``tests/test_classify.py``): the same ops, and the
64-bit forms' plain twins of K1, K1r, K4 ``level_fused_batched`` and K3
against the reference's Pallas kernels in interpret mode and its jnp
oracle; then, in the same child, the stream's entry points and
``stream.merge``, K5's plain twin on int64 codes, K7's on raw 64-bit keys
and int64 radix codes, ``s3_sort`` and the block path.  (The narrower keys
of those last entry points are held in ``tests/test_torch_stream_dtypes.py``
and ``tests/test_torch_classify_dtypes.py``.)

Inputs are made with numpy from a seed, with NaN of both signs, signed
zeros, infinities and the integer extremes.  Every comparison is exact,
through integer views (``assert_array_equal`` on floats would call any two
NaNs equal).
"""
import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import ops as ref_ops
from repro.classify.radix import radix_bucket_ids as ref_radix_bucket_ids
from repro.core.ips4o import SortConfig as RefConfig
from repro_torch import ops
from repro_torch.core import ips4o
from repro_torch.kernels import level_fused as lf
from torch_children import Child
from torch_one_thread import one_torch_thread  # noqa: F401

N = 3000
SMALL = dict(base_case=512, kmax=8, tile=256)
REF_CFG = RefConfig(**SMALL)
CFG = ips4o.config_from_reference(dataclasses.asdict(REF_CFG))
CPU = dict(device="cpu")
CLASSIFIERS = ("tree", "radix")
# numpy dtype (bfloat16 from ml_dtypes), torch dtype, the unsigned view
DTYPES = {
    "int8": (np.int8, torch.int8, np.uint8),
    "uint8": (np.uint8, torch.uint8, np.uint8),
    "int16": (np.int16, torch.int16, np.uint16),
    "uint16": (np.uint16, torch.uint16, np.uint16),
    "float16": (np.float16, torch.float16, np.uint16),
    "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, np.uint16),
    "uint32": (np.uint32, torch.uint32, np.uint32),
}


def make_keys(name: str, n: int = N, seed: int = 0) -> np.ndarray:
    """Keys of dtype ``name`` from a seed: heavy duplicates, the extremes,
    and for floats NaN of both signs, signed zeros and infinities."""
    np_dtype, _, udtype = DTYPES[name]
    rng = np.random.default_rng(seed)
    bits = np.dtype(udtype).itemsize * 8
    raw = rng.integers(0, 1 << bits, n, dtype=np.uint64).astype(udtype)
    raw[rng.random(n) < 0.3] = raw[0]  # a heavy duplicate
    x = raw.view(np_dtype).copy()
    if np.dtype(np_dtype).kind == "f" or np_dtype is ml_dtypes.bfloat16:
        x[::97] = np.nan
        x[1::89] = -np.array(np.nan, np_dtype)
        x[2::83] = 0.0
        x[3::79] = -np.array(0.0, np_dtype)
        x[4::73] = np.inf
        x[5::71] = -np.inf
    else:
        info = np.iinfo(np_dtype)
        x[::97] = info.max
        x[1::89] = info.min
    return x


def to_torch(x: np.ndarray, name: str) -> torch.Tensor:
    _, torch_dtype, udtype = DTYPES[name]
    return torch.from_numpy(x.view(udtype).copy()).view(torch_dtype)


def ubits(x, name: str) -> np.ndarray:
    """The bits of a port (torch) or reference (jax) key array."""
    udtype = DTYPES[name][2]
    if isinstance(x, torch.Tensor):
        signed = {np.uint8: torch.uint8, np.uint16: torch.int16, np.uint32: torch.int32}[udtype]
        return x.view(signed).numpy().view(udtype)
    return np.asarray(x).view(udtype)


@pytest.mark.parametrize("clf", CLASSIFIERS)
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_sort_argsort_and_payload(name, clf):
    x = make_keys(name, seed=1)
    t, j = to_torch(x, name), jnp.asarray(x)
    np.testing.assert_array_equal(ubits(ops.sort(t, cfg=CFG, classifier=clf, **CPU), name),
                                  ubits(ref_ops.sort(j, cfg=REF_CFG, classifier=clf), name))
    order = ops.argsort(t, cfg=CFG, classifier=clf, **CPU).numpy()
    np.testing.assert_array_equal(order, np.asarray(ref_ops.argsort(j, cfg=REF_CFG,
                                                                    classifier=clf)))
    np.testing.assert_array_equal(order, np.argsort(ops.keyspace.encode_np(x), kind="stable"))
    # a Pair-like payload of one uint64 word a key moves with it, bit for bit
    v = np.random.default_rng(2).integers(0, 1 << 62, (N, 1), dtype=np.uint64)
    keys, vals = ops.sort(t, torch.from_numpy(v), cfg=CFG, classifier=clf, **CPU)
    assert vals.dtype == torch.uint64
    np.testing.assert_array_equal(vals.view(torch.int64).numpy().view(np.uint64), v[order])


@pytest.mark.parametrize("clf", CLASSIFIERS)
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_topk_bottomk(name, clf):
    x = make_keys(name, seed=3)
    t, j = to_torch(x, name), jnp.asarray(x)
    for kk in (1, 700):
        for got, want in ((ops.topk(t, kk, cfg=CFG, classifier=clf, **CPU),
                           ref_ops.topk(j, kk, cfg=REF_CFG, classifier=clf)),
                          (ops.bottomk(t, kk, cfg=CFG, classifier=clf, **CPU),
                           ref_ops.bottomk(j, kk, cfg=REF_CFG, classifier=clf))):
            np.testing.assert_array_equal(ubits(got[0], name), ubits(want[0], name))
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("clf", CLASSIFIERS)
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_batched_ops(name, clf):
    x = make_keys(name, n=3 * 1000, seed=4).reshape(3, 1000)
    t, j = to_torch(x, name), jnp.asarray(x)
    kw, ref_kw = dict(cfg=CFG, classifier=clf, **CPU), dict(cfg=REF_CFG, classifier=clf)
    np.testing.assert_array_equal(ubits(ops.batched_sort(t, **kw), name),
                                  ubits(ref_ops.batched_sort(j, **ref_kw), name))
    np.testing.assert_array_equal(ops.batched_argsort(t, **kw).numpy(),
                                  np.asarray(ref_ops.batched_argsort(j, **ref_kw)))
    for got, want in ((ops.batched_topk(t, 300, **kw), ref_ops.batched_topk(j, 300, **ref_kw)),
                      (ops.batched_bottomk(t, 300, **kw),
                       ref_ops.batched_bottomk(j, 300, **ref_kw))):
        np.testing.assert_array_equal(ubits(got[0], name), ubits(want[0], name))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("clf", CLASSIFIERS)
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_segmented_group_by_unique(name, clf):
    """``segmented_sort`` takes the classifier and runs the tree, as the
    reference does; ``group_by`` and ``unique`` sort with the given
    classifier."""
    x = make_keys(name, seed=5)
    t, j = to_torch(x, name), jnp.asarray(x)
    cfg = dataclasses.replace(CFG, classifier=clf)
    ref_cfg = dataclasses.replace(REF_CFG, classifier=clf)
    off = np.asarray([0, 5, 5, 1200, 1201, 2500, N], np.int32)
    v = np.arange(N, dtype=np.int32)
    got_k, got_v = ops.segmented_sort(t, torch.from_numpy(off), 6, torch.from_numpy(v), cfg=CFG,
                                      classifier=clf, **CPU)
    want_k, want_v = ref_ops.segmented_sort(j, jnp.asarray(off), 6, jnp.asarray(v), cfg=REF_CFG,
                                            classifier=clf)
    np.testing.assert_array_equal(ubits(got_k, name), ubits(want_k, name))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    got, want = ops.group_by(t, torch.from_numpy(v), cfg=cfg, **CPU), \
        ref_ops.group_by(j, jnp.asarray(v), cfg=ref_cfg)
    np.testing.assert_array_equal(ubits(got.keys, name), ubits(want.keys, name))
    for field in ("group_ids", "counts", "perm", "values"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    assert int(got.num_groups) == int(want.num_groups)
    vals, counts, num = ops.unique(t, cfg=cfg, **CPU)
    want_vals, want_counts, want_num = ref_ops.unique(j, cfg=ref_cfg)
    # the whole padded outputs: the padding decodes the reference's zero code
    np.testing.assert_array_equal(ubits(vals, name), ubits(want_vals, name))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    assert int(num) == int(want_num)


@pytest.mark.parametrize("k", [2, 8, 128])
@pytest.mark.parametrize("name", ["int8", "uint8", "int16", "uint16", "float16", "bfloat16"])
def test_level1_radix_ids_of_narrow_keys(name, k):
    """The left-aligned int32 codes give level 1 the reference's radix
    digits: the port's K1r ids (its plain twin) equal the reference's
    ``classify.radix`` ids on the reference's narrow codes, the equality
    bucket of the all-ones code (the dtype's max or its NaN class)
    included."""
    x = make_keys(name, seed=k)
    enc = ops.keyspace.encode(to_torch(x, name))
    bucket, _, _ = lf._level_tiles_plain(enc[None], None, k, N, 256)
    want = ref_radix_bucket_ids(jnp.asarray(ops.keyspace.encode_np(x)), k, 0)
    np.testing.assert_array_equal(bucket[0].numpy(), np.asarray(want))


def test_paper_presets_match_the_reference():
    from repro.configs import ips4o_paper as ref_paper
    from repro_torch.configs import ips4o_paper

    assert ips4o_paper.PAPER_CPU == ref_paper.PAPER_CPU
    for name in ("TPU_DEFAULT", "TPU_BIG_PAYLOAD"):
        assert getattr(ips4o_paper, name) == ips4o.config_from_reference(
            dataclasses.asdict(getattr(ref_paper, name)))


X64_CHILD = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np, torch
from repro import ops as ref_ops
from repro.core.ips4o import SortConfig as RefConfig
from repro.kernels.level_fused import level_fused as ref_level_fused
from repro.kernels.level_fused import level_fused_batched as ref_level_fused_batched
from repro.kernels.ref import bitonic_sort_windows_ref
from repro_torch import ops
from repro_torch.core import ips4o
from repro_torch.kernels import bitonic, level_fused as lf

assert jax.config.jax_enable_x64
N = 3000
REF_CFG = RefConfig(base_case=512, kmax=8, tile=256)
CFG = ips4o.config_from_reference(dataclasses.asdict(REF_CFG))
CPU = dict(device="cpu")
I64 = np.iinfo(np.int64)


def keys(name, n, seed):
    rng = np.random.default_rng(seed)
    raw = rng.integers(I64.min, I64.max, n, dtype=np.int64, endpoint=True)
    raw[rng.random(n) < 0.3] = raw[0]
    if name == "float64":
        x = raw.view(np.float64).copy()
        normal = rng.random(n) < 0.5
        x[normal] = rng.standard_normal(int(normal.sum()))
        x[::97] = np.nan; x[1::89] = -np.nan; x[2::83] = 0.0; x[3::79] = -0.0
        x[4::73] = np.inf; x[5::71] = -np.inf
        return x
    raw[::97] = I64.max; raw[1::89] = I64.min
    return raw.view(np.uint64).copy() if name == "uint64" else raw


def tt(x):
    return torch.from_numpy(x.view(np.int64).copy()).view(
        {np.dtype(np.float64): torch.float64, np.dtype(np.uint64): torch.uint64,
         np.dtype(np.int64): torch.int64}[x.dtype])


def ub(x):
    return (x.view(torch.int64).numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            ).view(np.uint64)


def eq(a, b, what):
    np.testing.assert_array_equal(a, b, err_msg=what)


for name in ("int64", "uint64", "float64"):
    x = keys(name, N, 1)
    t, j = tt(x), jnp.asarray(x)
    for clf in ("tree", "radix"):
        kw, rkw = dict(cfg=CFG, classifier=clf, **CPU), dict(cfg=REF_CFG, classifier=clf)
        eq(ub(ops.sort(t, **kw)), ub(ref_ops.sort(j, **rkw)), f"{name} {clf} sort")
        order = ops.argsort(t, **kw).numpy()
        eq(order, np.asarray(ref_ops.argsort(j, **rkw)), f"{name} {clf} argsort")
        eq(order, np.argsort(ops.keyspace.encode_np(x), kind="stable"), f"{name} oracle")
        for kk in (1, 700):
            for got, want in ((ops.topk(t, kk, **kw), ref_ops.topk(j, kk, **rkw)),
                              (ops.bottomk(t, kk, **kw), ref_ops.bottomk(j, kk, **rkw))):
                eq(ub(got[0]), ub(want[0]), f"{name} {clf} top/bottom-k keys")
                eq(got[1].numpy(), np.asarray(want[1]), f"{name} {clf} top/bottom-k idx")
        xb, jb = t[:2400].reshape(3, 800), j[:2400].reshape(3, 800)
        eq(ub(ops.batched_sort(xb, **kw)), ub(ref_ops.batched_sort(jb, **rkw)), "batched_sort")
        eq(ops.batched_argsort(xb, **kw).numpy(), np.asarray(ref_ops.batched_argsort(jb, **rkw)),
           "batched_argsort")
        for got, want in ((ops.batched_topk(xb, 300, **kw), ref_ops.batched_topk(jb, 300, **rkw)),
                          (ops.batched_bottomk(xb, 300, **kw),
                           ref_ops.batched_bottomk(jb, 300, **rkw))):
            eq(ub(got[0]), ub(want[0]), f"{name} {clf} batched top/bottom-k keys")
            eq(got[1].numpy(), np.asarray(want[1]), f"{name} {clf} batched top/bottom-k idx")
    # the paper's Quartet: three uint64 payload words a key
    v = np.random.default_rng(2).integers(0, 1 << 62, (N, 3), dtype=np.uint64)
    _, vals = ops.sort(t, torch.from_numpy(v), cfg=CFG, **CPU)
    eq(ub(vals), v[np.argsort(ops.keyspace.encode_np(x), kind="stable")], f"{name} payload")
    off = np.asarray([0, 5, 5, 1200, 1201, 2500, N], np.int32)
    idx = np.arange(N, dtype=np.int32)
    for clf in ("tree", "radix"):
        cfg = dataclasses.replace(CFG, classifier=clf)
        ref_cfg = dataclasses.replace(REF_CFG, classifier=clf)
        gk, gv = ops.segmented_sort(t, torch.from_numpy(off), 6, torch.from_numpy(idx), cfg=CFG,
                                    classifier=clf, **CPU)
        wk, wv = ref_ops.segmented_sort(j, jnp.asarray(off), 6, jnp.asarray(idx), cfg=REF_CFG,
                                        classifier=clf)
        eq(ub(gk), ub(wk), f"{name} {clf} segmented keys")
        eq(gv.numpy(), np.asarray(wv), f"{name} {clf} segmented values")
        g, w = ops.group_by(t, torch.from_numpy(idx), cfg=cfg, **CPU), ref_ops.group_by(
            j, jnp.asarray(idx), cfg=ref_cfg)
        eq(ub(g.keys), ub(w.keys), f"{name} {clf} group_by keys")
        for field in ("group_ids", "counts", "perm", "values"):
            eq(getattr(g, field).numpy(), np.asarray(getattr(w, field)),
               f"{name} {clf} group_by {field}")
        assert int(g.num_groups) == int(w.num_groups)
        u, c, m = ops.unique(t, cfg=cfg, **CPU)
        wu, wc, wm = ref_ops.unique(j, cfg=ref_cfg)
        eq(ub(u), ub(wu), f"{name} {clf} unique values")
        eq(c.numpy(), np.asarray(wc), f"{name} {clf} unique counts")
        assert int(m) == int(wm)
print("ops OK")

# the 64-bit forms' plain twins: K1 and K1r (and K4 level_fused_batched per
# row) against the reference's Pallas kernel in interpret mode on its uint64
# codes, K3 against its jnp oracle
SIGN = np.uint64(1 << 63)
k, n, n_real, tile = 16, 4096, 4000, 1024
for name in ("float64", "int64"):
    x = keys(name, n, 7)
    code = ops.keyspace.encode(tt(x))
    u = ops.keyspace.reference_code_np(code.numpy(), tt(x).dtype)
    spl = torch.sort(code[torch.randperm(n, generator=torch.Generator().manual_seed(3))[:64]]
                     ).values[torch.arange(1, k) * 64 // k]
    for clf, s, consumed in (("tree", spl, 0), ("radix", None, 0), ("radix", None, 5)):
        dest, off = lf.level_fused_plain(code, s, k=k, n_real=n_real, tile=tile, classifier=clf,
                                         consumed_bits=consumed)
        ref_spl = None if s is None else jnp.asarray(ops.keyspace.reference_code_np(
            s.numpy(), tt(x).dtype))
        want_dest, want_off = ref_level_fused(jnp.asarray(u), ref_spl, k=k, n_real=n_real,
                                              classifier=clf, rows=tile // 128, interpret=True,
                                              consumed_bits=consumed)
        eq(dest.numpy(), np.asarray(want_dest), f"K1 64 {name} {clf} dest")
        eq(off.numpy(), np.asarray(want_off), f"K1 64 {name} {clf} offsets")
    rows = code.reshape(4, n // 4)
    urows = u.reshape(4, n // 4)
    spl_b = torch.sort(rows[:, :: (n // 4) // 32], dim=1).values[:, torch.arange(1, k) * 32 // k]
    for clf, s in (("tree", spl_b), ("radix", None)):
        dest, off = lf.level_fused_batched_plain(rows, s, k=k, n_real=n // 4 - 17, tile=256,
                                                 classifier=clf)
        ref_s = None if s is None else jnp.asarray(ops.keyspace.reference_code_np(
            s.numpy(), tt(x).dtype))
        want_dest, want_off = ref_level_fused_batched(jnp.asarray(urows), ref_s, k=k,
                                                      n_real=n // 4 - 17, classifier=clf,
                                                      rows=2, interpret=True)
        eq(dest.numpy(), np.asarray(want_dest), f"K4 64 {name} {clf} dest")
        eq(off.numpy(), np.asarray(want_off), f"K4 64 {name} {clf} offsets")
for W in (8, 256, 16384):
    rng = np.random.default_rng(W)
    b = np.sort(rng.integers(0, 9, (2, W)), axis=1).astype(np.int32)
    kk = rng.integers(-3, 4, (2, W)).astype(np.int64)
    kk[0, : W // 2] += I64.max - 3
    kk[1, :: 7] = I64.min
    idx = np.tile(np.arange(W, dtype=np.int32), (2, 1))
    perm, bucket_out = bitonic.sort_windows_plain(torch.from_numpy(b), torch.from_numpy(kk), nb=9)
    want_b, _, want_idx = bitonic_sort_windows_ref(jnp.asarray(b), jnp.asarray(kk),
                                                   jnp.asarray(idx))
    eq(perm.numpy(), np.asarray(want_idx), f"K3 64 W={W} perm")
    eq(bucket_out.numpy(), np.asarray(want_b), f"K3 64 W={W} bucket")
print("x64 parity OK")

# ---- the stream, K5, K7, s3_sort and the block path on 64-bit keys
import os, tempfile
from repro import stream as ref_stream
from repro.core.partition import partition_blocks as ref_partition_blocks
from repro.core.s3sort import s3_sort as ref_s3_sort
from repro.kernels import classify as ref_classify, ops as ref_kernel_ops
from repro.kernels.merge_path import merge_path_partition as ref_merge_path_partition
from repro.kernels.merge_path import merge_path_perm as ref_merge_path_perm
from repro.kernels.ref import merge_path_perm_ref
from repro.ops import PlanCache
from repro_torch import stream
from repro_torch.core.partition import partition_blocks
from repro_torch.core.s3sort import s3_sort
from repro_torch.kernels import classify, merge_path
from repro_torch.kernels.ops import sort_blocks

cache = PlanCache(path=os.path.join(tempfile.mkdtemp(), "p.json"))
ROWS = 8
TINY = np.finfo(np.float64).tiny


def tame(x, nan_inf=True):
    # the reference's float compares on the CPU flush subnormals to zero:
    # float64 keys for them are normal, and without NaN and inf for s3_sort
    if x.dtype == np.float64:
        x = x.copy()
        x[(x != 0) & (np.abs(x) < TINY)] = 1.5
        if not nan_inf:
            x[~np.isfinite(x)] = -2.5
    return x


def spl_of(x, k, seed):
    s = np.random.default_rng(seed).choice(x, k - 1, replace=False)
    return s[np.argsort(ops.keyspace.encode_np(s), kind="stable")]


def check(got, want, what):
    for g, w in zip(got, want):
        eq(g.numpy(), np.asarray(w), what)


for name in ("int64", "uint64", "float64"):
    x = keys(name, 4096, 11)
    got = stream.external_sort(x, chunk_size=1024, **CPU)
    assert got.dtype == x.dtype, name
    eq(ub(got), ub(ref_stream.external_sort(x, chunk_size=1024, cache=cache)),
       f"{name} external_sort")
    eq(stream.external_argsort(x[:3000], chunk_size=1024, **CPU),
       np.asarray(ref_stream.external_argsort(x[:3000], chunk_size=1024, cache=cache)),
       f"{name} external_argsort")
    for largest in (True, False):
        gv, gi = stream.streaming_topk(x, 300, chunk_size=1024, largest=largest, **CPU)
        wv, wi = ref_stream.streaming_topk(x, 300, chunk_size=1024, largest=largest,
                                           cache=cache)
        assert gv.dtype == x.dtype, name
        eq(ub(gv), ub(wv), f"{name} streaming_topk {largest}")
        eq(gi, np.asarray(wi), f"{name} streaming_topk {largest} idx")
    chunks = lambda: (x[lo:hi] for lo, hi in ((0, 1000), (1000, 2500), (2500, 4096)))
    gv, gc = stream.streaming_group_by(chunks(), chunk_size=1024, **CPU)
    wv, wc = ref_stream.streaming_group_by(chunks(), chunk_size=1024, cache=cache)
    assert gv.dtype == x.dtype, name
    eq(ub(gv), ub(wv), f"{name} streaming_group_by")
    eq(gc, np.asarray(wc), f"{name} streaming_group_by counts")
    runs, vals = [], []
    for lo, hi in ((0, 300), (300, 300), (300, 650), (650, 900)):
        order = np.argsort(ops.keyspace.encode_np(x[lo:hi]), kind="stable")
        runs.append(x[lo:hi][order])
        vals.append((lo + order).astype(np.int32))
    gk, gv = stream.merge([tt(r) for r in runs], values=[torch.as_tensor(v) for v in vals],
                          tile=64)
    wk, wv = ref_stream.merge([jnp.asarray(r) for r in runs],
                              values=[jnp.asarray(v) for v in vals], engine="xla")
    eq(ub(gk), ub(wk), f"{name} merge keys")
    eq(gv.numpy(), np.asarray(wv), f"{name} merge values")
print("x64 stream OK")

# K5's plain twin on int64 codes against the reference's Pallas kernel on its
# uint64 codes (the same keys), duplicate-heavy, the codes of NaN at the ends
for name, na, nb in (("float64", 3000, 2000), ("uint64", 257, 1300), ("int64", 1, 399)):
    x = keys(name, na + nb, 12)
    x[np.random.default_rng(13).random(na + nb) < 0.5] = x[7]
    code = ops.keyspace.encode(tt(x))
    a, b = torch.sort(code[:na]).values, torch.sort(code[na:]).values
    if name == "float64":
        a[-3:] = torch.iinfo(torch.int64).max
        b[-1:] = torch.iinfo(torch.int64).max
    ua = ops.keyspace.reference_code_np(a.numpy(), torch.float64)
    ubb = ops.keyspace.reference_code_np(b.numpy(), torch.float64)
    got = merge_path.merge_path_perm(a, b)
    eq(got.numpy(), np.asarray(merge_path_perm_ref(jnp.asarray(ua), jnp.asarray(ubb))),
       f"K5 64 {name} ref")
    eq(got.numpy(), np.asarray(ref_merge_path_perm(jnp.asarray(ua), jnp.asarray(ubb), tile=256,
                                                   interpret=True)), f"K5 64 {name} kernel")
    d = np.arange(0, na + nb + 1, 97, dtype=np.int32)
    eq(merge_path.merge_path_partition(a, b, torch.as_tensor(d)).numpy(),
       np.asarray(ref_merge_path_partition(jnp.asarray(ua), jnp.asarray(ubb), jnp.asarray(d))),
       f"K5 64 {name} partition")
print("x64 K5 OK")

# K7's plain twins on raw 64-bit keys (NaN, +-0.0, +-inf, the extremes) and
# on int64 radix codes against the reference's Pallas kernels in interpret mode
for name in ("int64", "uint64", "float64"):
    x = tame(keys(name, 3 * ROWS * 128, 14))
    t = tt(x)
    for k in (16, 128):
        spl = spl_of(x, k, k)
        check(classify.classify_histogram(t, tt(spl), k=k, rows=ROWS),
              ref_classify.classify_histogram(jnp.asarray(x), jnp.asarray(spl), k=k, rows=ROWS,
                                              interpret=True), f"K7 64 {name} k={k}")
    xb = x[: 2 * ROWS * 128].reshape(2, -1)
    sb = np.stack([spl_of(r, 16, 20 + i) for i, r in enumerate(xb)])
    check(classify.classify_histogram_batched(tt(xb), tt(sb), k=16, rows=ROWS),
          ref_classify.classify_histogram_batched(jnp.asarray(xb), jnp.asarray(sb), k=16,
                                                  rows=ROWS, interpret=True),
          f"K7 64 {name} batched")
    x = tame(keys(name, 1 << 14, 15))
    spl = spl_of(x, 32, 16)
    check(classify.classify_histogram(tt(x), tt(spl), k=32),
          ref_classify.classify_histogram(jnp.asarray(x), jnp.asarray(spl), k=32,
                                          interpret=True), f"K7 64 {name} rows=None")
    code = ops.keyspace.encode(tt(x))
    u = jnp.asarray(ops.keyspace.reference_code_np(code.numpy(), tt(x).dtype))
    for consumed in (0, 8, 56):
        check(classify.radix_histogram(code, k=256, consumed_bits=consumed, rows=ROWS),
              ref_classify.radix_histogram(u, k=256, consumed_bits=consumed, rows=ROWS,
                                           interpret=True), f"K7 64 {name} radix {consumed}")
    check(classify.radix_histogram_batched(code.reshape(4, -1), k=16, consumed_bits=4),
          ref_classify.radix_histogram_batched(u.reshape(4, -1), k=16, consumed_bits=4,
                                               interpret=True), f"K7 64 {name} radix batched")
print("x64 K7 OK")

# s3_sort without NaN and inf (the reference's caveat), and the block path
for name in ("int64", "uint64", "float64"):
    x = tame(keys(name, 30000, 17), nan_inf=False)
    v = np.arange(x.shape[0], dtype=np.int32)
    ks, vs = s3_sort(tt(x), torch.from_numpy(v))
    rk, rv = ref_s3_sort(jnp.asarray(x), jnp.asarray(v))
    assert ks.dtype == tt(x).dtype, name
    eq(ub(ks), ub(rk), f"{name} s3_sort keys")
    eq(vs.numpy(), np.asarray(rv), f"{name} s3_sort values")
    k, nblocks, be = 4, 24, 128
    x = keys(name, nblocks * be, 18)
    bb = np.random.default_rng(19).integers(0, k, nblocks).astype(np.int32)
    t = tt(x)
    got, d = sort_blocks(t, torch.from_numpy(bb), k=k, block_elems=be)
    want, want_d = ref_kernel_ops.sort_blocks(jnp.asarray(x), jnp.asarray(bb), k=k,
                                              block_elems=be)
    assert got.data_ptr() == t.data_ptr()
    eq(ub(got), ub(want), f"{name} sort_blocks")
    eq(d.numpy(), np.asarray(want_d), f"{name} sort_blocks offsets")
    pay = np.random.default_rng(20).integers(0, 1 << 62, (nblocks * be, 3), dtype=np.uint64)
    got, d = partition_blocks({"k": tt(x), "v": torch.from_numpy(pay)}, torch.from_numpy(bb),
                              k, be)
    want, want_d = ref_partition_blocks({"k": jnp.asarray(x), "v": jnp.asarray(pay)},
                                        jnp.asarray(bb), k, be)
    eq(ub(got["k"]), ub(want["k"]), f"{name} partition_blocks keys")
    eq(ub(got["v"]), np.asarray(want["v"]), f"{name} partition_blocks payload")
    eq(d.numpy(), np.asarray(want_d), f"{name} partition_blocks offsets")
print("x64 s3 and blocks OK")

# ---- the glue's int64 forms: G3's twin on int64 codes (both modes) against
# seg * 2k + the reference's classify_segmented / radix ids on uint64
# codes, G4's scatter of 8-byte rows against .at[dest].set
from repro.classify.radix import radix_bucket_ids as ref_radix_bucket_ids
from repro.classify.tree import classify_segmented as ref_classify_segmented
from repro.core.ips4o import segment_ids as ref_segment_ids
from repro_torch.kernels import glue
n = 5000
for k, num_seg in ((2, 1), (16, 40), (128, 7)):
    rng = np.random.default_rng(k + num_seg)
    x = keys("int64", n, k)
    code = ops.keyspace.encode(tt(x))
    u = ops.keyspace.reference_code_np(code.numpy(), torch.int64)
    off = np.concatenate([[0], np.sort(rng.integers(0, n + 1, num_seg - 1)), [n]]).astype(np.int32)
    if num_seg > 1:
        off[-2] = n  # an empty last segment
    spl = torch.sort(code[torch.as_tensor(rng.integers(0, n, (num_seg, k - 1)))], dim=1).values
    code[1::7] = spl.reshape(-1)[torch.arange(len(code[1::7])) % spl.numel()]
    u = ops.keyspace.reference_code_np(code.numpy(), torch.int64)
    seg = np.asarray(ref_segment_ids(jnp.asarray(off), n))
    got = glue.composite_ids(code[None], torch.as_tensor(off)[None], num_seg, k, spl[None])
    ref_spl = ops.keyspace.reference_code_np(spl.numpy(), torch.int64)
    want = seg * 2 * k + np.asarray(ref_classify_segmented(jnp.asarray(u), jnp.asarray(seg),
                                                           jnp.asarray(ref_spl), k))
    eq(got[0].numpy(), want, f"G3 64 k={k} segments={num_seg}")
    for consumed in (0, 9):
        got = glue.composite_ids(code[None], torch.as_tensor(off)[None], num_seg, k, None,
                                 consumed)
        want = seg * 2 * k + np.asarray(ref_radix_bucket_ids(jnp.asarray(u), k, consumed))
        eq(got[0].numpy(), want, f"G3 64 radix k={k} consumed={consumed}")
    dest = rng.permutation(n).astype(np.int32)
    got = ips4o._scatter({"v": code}, torch.as_tensor(dest))["v"]
    eq(got.numpy(), np.asarray(jnp.zeros(n, jnp.int64).at[dest].set(jnp.asarray(code.numpy()))),
       f"G4 scatter of int64 rows k={k}")
print("x64 glue OK")
"""


@pytest.fixture(scope="module", autouse=True)
def x64_started():
    """One child process with x64 enabled from startup for the module's
    64-bit tests, started with the module so that it runs beside the others."""
    child = Child(X64_CHILD)
    yield child
    child.stop()


@pytest.fixture(scope="module")
def x64_child(x64_started):
    return x64_started.result(timeout=600)


def test_64bit_dtypes_in_an_x64_child(x64_child):
    """int64, uint64 and float64 keys: the ops against the reference, and
    the 64-bit plain twins of K1, K1r, K4 and K3 against its kernels, in a
    child process with x64 enabled from startup."""
    out = x64_child.stdout
    assert "ops OK" in out and "x64 parity OK" in out, out + x64_child.stderr[-5000:]


def test_64bit_glue_in_the_x64_child(x64_child):
    """The glue's int64 forms in the same child: G3's plain twin on int64
    codes, tree and radix, against ``seg * 2k`` + the reference's
    ``classify_segmented`` and radix ids on uint64 codes, and G4's scatter
    of int64 rows against ``.at[dest].set``."""
    assert "x64 glue OK" in x64_child.stdout, x64_child.stdout + x64_child.stderr[-5000:]


def test_64bit_stream_k5_k7_s3_and_blocks_in_the_x64_child(x64_child):
    """int64, uint64 and float64 keys in the same child: every stream entry
    point and ``stream.merge``, K5's plain twin on int64 codes against the
    reference's ``merge_path_perm`` on uint64 codes, K7's plain twins on raw
    keys and int64 radix codes against its Pallas kernels in interpret
    mode, ``s3_sort``, ``sort_blocks`` and ``partition_blocks``."""
    assert x64_child.returncode == 0, x64_child.stdout + x64_child.stderr[-5000:]
    for part in ("x64 stream OK", "x64 K5 OK", "x64 K7 OK", "x64 s3 and blocks OK"):
        assert part in x64_child.stdout, part
