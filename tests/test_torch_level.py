"""Parity of the port's level passes with the reference, on the CPU.

The port's plain K1 (``level_fused``) and K2 (``rank_hist``) against the
reference's Pallas kernels in interpret mode, the segment-aware K2 formula
against the plain stable partition, the tree classifier and sampling
helpers against ``repro``'s, whole partition passes fed the reference's
own splitters, and ``config_from_reference``.  All outputs are integers or
permutations: the tolerance is exact equality everywhere.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.classify import classify as ref_classify
from repro.classify import classify_segmented as ref_classify_segmented
from repro.core import ips4o as ref_ips4o
from repro.core import sampling as ref_sampling
from repro.core.partition import partition_permutation as ref_partition_permutation
from repro.data.distributions import DISTRIBUTIONS, make_input
from repro.kernels.level_fused import level_fused as ref_level_fused
from repro.kernels.level_fused import rank_hist as ref_rank_hist
from repro.ops import keyspace as ref_keyspace
from repro_torch.classify import classify, classify_segmented
from repro_torch.core import ips4o, sampling
from repro_torch.core.partition import partition_permutation, stable_partition
from repro_torch.kernels.level_fused import level_fused, rank_hist
from torch_one_thread import one_torch_thread  # noqa: F401

SIGN = np.uint32(0x80000000)
SMALL = dict(base_case=1024, kmax=32, tile=256, max_sample=256, slack=4)


def to_port(u):
    """Reference uint32 codes -> the port's signed int32 codes."""
    return torch.as_tensor((np.asarray(u, np.uint32) ^ SIGN).view(np.int32).copy())


def to_ref(t):
    """The port's signed int32 codes -> reference uint32 codes."""
    return t.numpy().view(np.uint32) ^ SIGN


def _encoded(dist, n, dtype, seed=7):
    return ref_keyspace.encode_np(make_input(dist, n, dtype, seed=seed))


def _splitters(u, k, n_real):
    return np.sort(u[:n_real][: min(256, n_real)])[(np.arange(1, k) * min(256, n_real)) // k]


# ---------------------------------------------------------------------------
# K1: plain level_fused vs the reference kernel (interpret mode)


@pytest.mark.parametrize("n_real", [6144, 6000])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("dist", sorted(DISTRIBUTIONS))
def test_level_fused_matches_reference(dist, dtype, n_real):
    n, k = 6144, 32
    u = _encoded(dist, n, dtype)
    u[n_real:] = np.iinfo(np.uint32).max  # pads hold the sentinel
    spl = _splitters(u, k, n_real)
    want_dest, want_off = ref_level_fused(
        jnp.asarray(u), jnp.asarray(spl), k=k, n_real=n_real, interpret=True
    )
    for tile in (256, 4096):  # the placement does not depend on the tiling
        dest, off = level_fused(to_port(u), to_port(spl), k=k, n_real=n_real, tile=tile)
        np.testing.assert_array_equal(dest.numpy(), np.asarray(want_dest))
        np.testing.assert_array_equal(off.numpy(), np.asarray(want_off))


# ---------------------------------------------------------------------------
# K2: plain rank_hist vs the reference kernel, and the segment-aware form


@pytest.mark.parametrize("nb", [3, 65, 520])
def test_rank_hist_matches_reference(nb):
    rng = np.random.default_rng(nb)
    ids = rng.integers(0, nb, 5000).astype(np.int32)  # not a multiple of any tile
    want_dest, want_off = ref_rank_hist(jnp.asarray(ids), nb=nb, interpret=True)
    dest, off = rank_hist(torch.as_tensor(ids), nb=nb, tile=512)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(want_dest))
    np.testing.assert_array_equal(off.numpy(), np.asarray(want_off))


def _segments(rng, n, num_seg):
    """Sorted segment boundaries with some empty segments."""
    cuts = np.sort(rng.integers(0, n + 1, num_seg - 1))
    cuts[: num_seg // 4] = cuts[0]  # a run of empty segments
    return np.concatenate([[0], cuts, [n]]).astype(np.int32)


@pytest.mark.parametrize(
    "n,num_seg,width,tile",
    [(4096, 9, 8, 256), (5000, 33, 64, 128), (3000, 5, 2, 4096), (2048, 257, 16, 64)],
)
def test_segmented_rank_hist_matches_partition(n, num_seg, width, tile):
    rng = np.random.default_rng(n + num_seg)
    off = _segments(rng, n, num_seg)
    seg = np.searchsorted(off, np.arange(n), side="right") - 1
    comp = (seg * width + rng.integers(0, width, n)).astype(np.int32)
    nb = num_seg * width
    dest, offsets = rank_hist(
        torch.as_tensor(comp), nb=nb, seg_offsets=torch.as_tensor(off),
        seg_width=width, tile=tile,
    )
    perm, want_off = partition_permutation(torch.as_tensor(comp), nb, n)
    inverse = torch.empty_like(perm)
    inverse[perm] = torch.arange(n)
    np.testing.assert_array_equal(dest.numpy(), inverse.numpy())
    np.testing.assert_array_equal(offsets.numpy(), want_off.numpy())
    ref_perm, ref_off = ref_partition_permutation(jnp.asarray(comp), nb, n)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(ref_perm))
    np.testing.assert_array_equal(offsets.numpy(), np.asarray(ref_off))


@pytest.mark.parametrize("tile", [64, 256, 1024])
def test_partition_permutation_matches_reference(tile):
    rng = np.random.default_rng(tile)
    ids = rng.integers(0, 37, 2048).astype(np.int32)
    perm, off = partition_permutation(torch.as_tensor(ids), 37, tile)
    want_perm, want_off = ref_partition_permutation(jnp.asarray(ids), 37, tile)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(want_perm))
    np.testing.assert_array_equal(off.numpy(), np.asarray(want_off))
    vals = torch.as_tensor(rng.standard_normal(2048).astype(np.float32))
    out, off2 = stable_partition(torch.as_tensor(ids), {"v": vals}, 37, tile)
    np.testing.assert_array_equal(out["v"].numpy(), vals.numpy()[np.asarray(want_perm)])
    np.testing.assert_array_equal(off2.numpy(), np.asarray(want_off))


# ---------------------------------------------------------------------------
# classifier and sampling helpers


@pytest.mark.parametrize("k", [2, 8, 128])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_classify_matches_reference(k, dtype):
    u = _encoded("TwoDup" if dtype == np.int32 else "Exponential", 3000, dtype, seed=k)
    spl = np.sort(u[np.random.default_rng(k).integers(0, 3000, k - 1)])
    want = ref_classify(jnp.asarray(u), jnp.asarray(spl), k)
    np.testing.assert_array_equal(classify(to_port(u), to_port(spl), k).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("k", [2, 16])
def test_classify_segmented_matches_reference(k):
    rng = np.random.default_rng(k)
    n, num_seg = 4000, 7
    off = _segments(rng, n, num_seg)
    seg = (np.searchsorted(off, np.arange(n), side="right") - 1).astype(np.int32)
    u = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    u[::5] = u[0]  # duplicates that hit splitters
    spl = rng.choice(u, (num_seg, k - 1)).astype(np.uint32)
    spl[0, 0] = u[0]
    spl = np.sort(spl, axis=1)
    want = ref_classify_segmented(jnp.asarray(u), jnp.asarray(seg), jnp.asarray(spl), k)
    got = classify_segmented(to_port(u), torch.as_tensor(seg), to_port(spl), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampling_helpers_match_reference():
    for k in (2, 4, 128):
        np.testing.assert_array_equal(sampling.tree_permutation(k),
                                      ref_sampling.tree_permutation(k))
        spl = np.arange(k - 1, dtype=np.int32) * 3
        np.testing.assert_array_equal(
            sampling.build_tree(torch.as_tensor(spl), k).numpy(),
            np.asarray(ref_sampling.build_tree(jnp.asarray(spl), k)),
        )
    for n in (1, 2, 1000, 2**24):
        assert sampling.oversampling_factor(n) == ref_sampling.oversampling_factor(n)
    s = np.sort(np.random.default_rng(0).integers(0, 100, (3, 50))).astype(np.int32)
    np.testing.assert_array_equal(
        sampling.select_splitters(torch.as_tensor(s), 8).numpy(),
        np.asarray(ref_sampling.select_splitters(jnp.asarray(s), 8)),
    )
    g = torch.Generator().manual_seed(0)
    lo, hi = torch.tensor([0, 10, 10], dtype=torch.int32), torch.tensor([10, 10, 13],
                                                                         dtype=torch.int32)
    pos = sampling.sample_indices(g, 64, lo, hi)
    assert pos.shape == (3, 64)
    assert bool((pos[0] < 10).all() and (pos[1] == 10).all())
    assert bool(((pos[2] >= 10) & (pos[2] < 13)).all())


# ---------------------------------------------------------------------------
# whole level passes, fed the reference's own splitters


def _reference_run(u_pad, n_real, ref_cfg, levels):
    """The reference's partition passes plus the splitters it sampled at
    each level, replicated from its jax.random draws."""
    arrays = {"k": jnp.asarray(u_pad)}
    r1, r2 = jax.random.split(jax.random.PRNGKey(ref_cfg.seed))
    k1 = levels[0]
    m1 = min(max(ref_sampling.oversampling_factor(n_real) * k1, k1),
             ref_cfg.max_sample, n_real)
    pos = jax.random.randint(r1, (m1,), 0, n_real)
    spl = [ref_sampling.select_splitters(jnp.sort(jnp.take(arrays["k"], pos)), k1)]
    if len(levels) == 2:
        a1, off1, nb1, _ = ref_ips4o.level_pass(arrays, n_real, k1, ref_cfg, r1)
        k2 = levels[1]
        m = min(max(ref_sampling.oversampling_factor(n_real) * k2, k2), 2048)
        spos = jax.vmap(lambda r, lo, hi: ref_sampling.sample_indices(r, m, lo, hi))(
            jax.random.split(r2, nb1), off1[:-1], off1[1:]
        )
        svals = jnp.sort(jnp.take(a1["k"], spos.reshape(-1), axis=0).reshape(nb1, m), -1)
        spl.append(ref_sampling.select_splitters(svals, k2))
    out, off, nb, pad_bucket = ref_ips4o.partition_passes(arrays, n_real, ref_cfg, levels)
    return [np.asarray(s) for s in spl], np.asarray(out["k"]), np.asarray(off), nb, pad_bucket


@pytest.mark.parametrize("n", [5000, 20000])
@pytest.mark.parametrize("dist", ["Uniform", "RootDup", "EightDup", "Sorted"])
def test_partition_passes_match_reference(dist, n):
    ref_cfg = ref_ips4o.SortConfig(**SMALL)
    cfg = ips4o.config_from_reference(dataclasses.asdict(ref_cfg))
    u = _encoded(dist, n, np.float32, seed=3)
    n_pad = -(-n // 1024) * 1024
    u_pad = np.concatenate([u, np.full(n_pad - n, np.iinfo(np.uint32).max, np.uint32)])
    levels = ips4o.plan_levels(n_pad, cfg)
    assert levels == ref_ips4o.plan_levels(n_pad, ref_cfg) and len(levels) == (
        1 if n == 5000 else 2)
    spl, want_keys, want_off, want_nb, want_pad = _reference_run(u_pad, n, ref_cfg, levels)
    arrays = ips4o.pad_with_sentinel({"k": to_port(u)}, 1024)
    out, off, nb, pad_bucket = ips4o.partition_passes(
        arrays, n, cfg, levels, splitters=[to_port(s) for s in spl]
    )
    assert (nb, pad_bucket) == (want_nb, want_pad)
    np.testing.assert_array_equal(off.numpy(), want_off)
    np.testing.assert_array_equal(to_ref(out["k"]), want_keys)
    assert bool(ips4o.bucket_violations(off, nb, 1024, pad_bucket)) == bool(
        ref_ips4o.bucket_violations(jnp.asarray(want_off), want_nb, 1024, want_pad))


# ---------------------------------------------------------------------------
# config and wrapper contracts


def test_config_from_reference_round_trip():
    for ref_cfg in (ref_ips4o.SortConfig(), ref_ips4o.SortConfig(**SMALL, seed=5,
                                                                 engine="pallas")):
        d = dataclasses.asdict(ref_cfg)
        cfg = ips4o.config_from_reference(d)
        got = dataclasses.asdict(cfg)
        assert got == {key: d[key] for key in got}
        assert set(d) - set(got) == {"engine", "classify_rows"}
        for n in (cfg.base_case, 16 * cfg.base_case, 64 * cfg.base_case):
            assert ips4o.plan_levels(n, cfg) == ref_ips4o.plan_levels(n, ref_cfg)
    radix = ips4o.config_from_reference(dataclasses.asdict(ref_ips4o.SortConfig(
        classifier="radix")))
    assert radix.classifier == "radix"
    for name in ("learned", "auto"):  # ported since the learned classifier and router
        assert ips4o.config_from_reference(dataclasses.asdict(ref_ips4o.SortConfig(
            classifier=name))).classifier == name
    with pytest.raises(ValueError, match="classifier"):
        ips4o.config_from_reference({"classifier": "neural"})
    with pytest.raises(ValueError, match="unknown"):
        ips4o.config_from_reference({"bogus": 1})


def test_wrappers_validate_their_inputs():
    keys = torch.zeros(256, dtype=torch.int32)
    spl = torch.zeros(7, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        level_fused(keys.to(torch.int64), spl, k=8)
    with pytest.raises(ValueError, match="power of two"):
        level_fused(keys, torch.zeros(5, dtype=torch.int32), k=6)
    with pytest.raises(ValueError, match="splitters"):
        level_fused(keys, spl[:3], k=8)
    with pytest.raises(ValueError, match="seg_width"):
        rank_hist(keys, nb=10, seg_offsets=torch.tensor([0, 256], dtype=torch.int32),
                  seg_width=3)
    with pytest.raises(ValueError, match="MAX_NB"):
        rank_hist(keys, nb=4096)
