"""Parity of the port's batched (B, n) pipeline with the reference, on the CPU.

The plain K4 ``level_fused_batched`` (tree mode fed the reference's
per-row splitters, and radix mode) and ``rank_hist_batched`` against the
reference's Pallas kernels in interpret mode; the row-aligned segment form
of ``rank_hist_batched`` against the plain ``batched_stable_partition``;
whole batched partition passes (radix with no splitters fed in, tree fed
the reference's); and ``batched_sort``/``argsort``/``topk``/``bottomk``
against ``repro.ops`` over the nine generators (one per row, with two
special rows) x {float32, int32} x {tree, radix} at one- and two-level
sizes, plus the edge cases.
All outputs are integers or permutations: the tolerance is exact equality
everywhere.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as ref_ops
from repro.core import ips4o as ref_ips4o
from repro.core import sampling as ref_sampling
from repro.core.partition import batched_stable_partition as ref_batched_stable_partition
from repro.data.distributions import DISTRIBUTIONS, make_input
from repro.kernels.level_fused import level_fused_batched as ref_level_fused_batched
from repro.kernels.level_fused import rank_hist_batched as ref_rank_hist_batched
from repro.ops import keyspace as ref_keyspace
from repro_torch import ops
from repro_torch.core import ips4o
from repro_torch.core.partition import batched_stable_partition
from repro_torch.kernels.level_fused import level_fused_batched, rank_hist_batched
from test_torch_level import to_port, to_ref
from test_torch_sort import bits
from torch_one_thread import one_torch_thread  # noqa: F401

# one level up to n = 512, two levels up to n = 4096 (W = 256, kmax = 8)
TINY = dict(base_case=256, kmax=8, tile=128, max_sample=64, slack=4)
UMAX = np.iinfo(np.uint32).max


def _configs(classifier):
    ref_cfg = ref_ips4o.SortConfig(**TINY, classifier=classifier)
    return ref_cfg, ips4o.config_from_reference(dataclasses.asdict(ref_cfg))


def _specials(B, n, seed):
    x = np.random.default_rng(seed).standard_normal((B, n)).astype(np.float32)
    x[:, ::7] = np.nan
    x[:, 1::11] = -0.0
    x[:, 2::13] = 0.0
    x[0, 3::5] = np.float32(np.nan) * -1
    x[1] = -0.0  # a row of one key
    return x


def _rows(n, dtype, seed=3):
    """One row per generator and two special rows, (11, n): NaNs and signed
    zeros for float32, the extremes and one repeated key for int32 (one
    shape for both dtypes, so the reference compiles its pipeline once)."""
    x = np.stack([make_input(d, n, dtype, seed=seed) for d in sorted(DISTRIBUTIONS)])
    if dtype == np.float32:
        return np.concatenate([x, _specials(2, n, seed)])
    info = np.iinfo(np.int32)
    extremes = np.random.default_rng(seed).choice([info.min, info.max, 0, -1], n)
    return np.concatenate([x, extremes[None].astype(np.int32), np.full((1, n), 7, np.int32)])


def check_batched(x, ref_cfg, cfg, k=37):
    """The port's four batched ops equal the reference's on ``x`` (B, n)."""
    want_order = np.asarray(ref_ops.batched_argsort(jnp.asarray(x), cfg=ref_cfg))
    got_order = ops.batched_argsort(torch.as_tensor(x), cfg=cfg, device="cpu").numpy()
    np.testing.assert_array_equal(got_order, want_order)
    oracle = np.argsort(ref_keyspace.encode_np(x), axis=1, kind="stable")
    np.testing.assert_array_equal(got_order, oracle)  # stable per row
    want_keys = np.asarray(ref_ops.batched_sort(jnp.asarray(x), cfg=ref_cfg))
    got_keys = ops.batched_sort(torch.as_tensor(x), cfg=cfg, device="cpu").numpy()
    np.testing.assert_array_equal(bits(got_keys), bits(want_keys))
    for op, ref_op in ((ops.batched_topk, ref_ops.batched_topk),
                       (ops.batched_bottomk, ref_ops.batched_bottomk)):
        want_v, want_i = ref_op(jnp.asarray(x), k, cfg=ref_cfg)
        got_v, got_i = op(torch.as_tensor(x), k, cfg=cfg, device="cpu")
        np.testing.assert_array_equal(bits(got_v.numpy()), bits(np.asarray(want_v)))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        assert got_i.dtype == torch.int32


# ---------------------------------------------------------------------------
# K4: plain level_fused_batched and rank_hist_batched vs the reference kernels


@pytest.mark.parametrize("mode", ["tree", "radix-0", "radix-3"])
@pytest.mark.parametrize("n_real", [2048, 1900])
def test_level_fused_batched_matches_reference(mode, n_real):
    B, n, k = 3, 2048, 16
    u = np.stack([ref_keyspace.encode_np(make_input(d, n, np.float32, seed=1))
                  for d in ("Uniform", "TwoDup", "Exponential")])
    u[:, n_real:] = UMAX  # every row's pads hold the sentinel
    classifier, consumed = (mode, 0) if mode == "tree" else ("radix", int(mode[-1]))
    spl = None
    if classifier == "tree":  # each row its own splitters
        spl = np.sort(u[:, :256], axis=1)[:, (np.arange(1, k) * 256) // k]
    want_dest, want_off = ref_level_fused_batched(
        jnp.asarray(u), None if spl is None else jnp.asarray(spl), k=k, n_real=n_real,
        classifier=classifier, consumed_bits=consumed, interpret=True,
    )
    for tile in (128, 1024):  # the placement does not depend on the tiling
        dest, off = level_fused_batched(
            to_port(u), None if spl is None else to_port(spl), k=k, n_real=n_real,
            tile=tile, classifier=classifier, consumed_bits=consumed,
        )
        np.testing.assert_array_equal(dest.numpy(), np.asarray(want_dest))
        np.testing.assert_array_equal(off.numpy(), np.asarray(want_off))


@pytest.mark.parametrize("nb", [3, 65, 520])
def test_rank_hist_batched_matches_reference(nb):
    rng = np.random.default_rng(nb)
    ids = rng.integers(0, nb, (4, 1500)).astype(np.int32)  # not a multiple of any tile
    ids[1] = nb - 1  # a row of one bucket
    want_dest, want_off = ref_rank_hist_batched(jnp.asarray(ids), nb=nb, interpret=True)
    dest, off = rank_hist_batched(torch.as_tensor(ids), nb=nb, tile=256)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(want_dest))
    np.testing.assert_array_equal(off.numpy(), np.asarray(want_off))


@pytest.mark.parametrize("B,n,num_seg,width,tile", [(3, 2048, 9, 8, 128), (5, 1024, 33, 16, 64),
                                                    (2, 4096, 3, 256, 4096)])
def test_segmented_rank_hist_batched_matches_partition(B, n, num_seg, width, tile):
    rng = np.random.default_rng(n + num_seg)
    cuts = np.sort(rng.integers(0, n + 1, (B, num_seg - 1)), axis=1)
    cuts[:, : num_seg // 4] = cuts[:, :1]  # runs of empty segments
    off = np.concatenate([np.zeros((B, 1)), cuts, np.full((B, 1), n)], 1).astype(np.int32)
    seg = np.stack([np.searchsorted(o, np.arange(n), side="right") - 1 for o in off])
    comp = (seg * width + rng.integers(0, width, (B, n))).astype(np.int32)
    nb = num_seg * width
    dest, offsets = rank_hist_batched(torch.as_tensor(comp), nb=nb,
                                      seg_offsets=torch.as_tensor(off), seg_width=width,
                                      tile=tile)
    idx = torch.arange(n).expand(B, n)
    moved, want_off = batched_stable_partition(torch.as_tensor(comp), {"i": idx}, nb, n)
    inverse = torch.empty_like(moved["i"])
    inverse.scatter_(1, moved["i"], idx)
    np.testing.assert_array_equal(dest.numpy(), inverse.numpy())
    np.testing.assert_array_equal(offsets.numpy(), want_off.numpy())


def test_batched_stable_partition_matches_reference():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 37, (3, 2048)).astype(np.int32)
    vals = rng.standard_normal((3, 2048, 2)).astype(np.float32)  # a trailing dim moves too
    want, want_off = ref_batched_stable_partition(jnp.asarray(ids), {"v": jnp.asarray(vals)},
                                                  37, 256)
    got, off = batched_stable_partition(torch.as_tensor(ids), {"v": torch.as_tensor(vals)},
                                        37, 256)
    np.testing.assert_array_equal(got["v"].numpy(), np.asarray(want["v"]))
    np.testing.assert_array_equal(off.numpy(), np.asarray(want_off))


# ---------------------------------------------------------------------------
# whole batched partition passes


def _reference_splitters(u_pad, n_real, ref_cfg, levels):
    """The per-row splitters the reference samples at each level,
    replicated from its jax.random draws."""
    keys = jnp.asarray(u_pad)
    B = keys.shape[0]
    r1, r2 = jax.random.split(jax.random.PRNGKey(ref_cfg.seed))
    k1 = levels[0]
    m1 = min(max(ref_sampling.oversampling_factor(n_real) * k1, k1), ref_cfg.max_sample,
             n_real)
    pos = jax.vmap(lambda r: jax.random.randint(r, (m1,), 0, n_real))(jax.random.split(r1, B))
    spl = [ref_sampling.select_splitters(
        jnp.sort(jnp.take_along_axis(keys, pos, axis=1), axis=1), k1)]
    if len(levels) == 2:
        a1, off1, nb1, _ = ref_ips4o.batched_level_pass({"k": keys}, n_real, k1, ref_cfg, r1)
        k2 = levels[1]
        m = min(max(ref_sampling.oversampling_factor(n_real) * k2, k2), 2048)
        rngs = jax.random.split(r2, B * nb1).reshape(B, nb1, -1)
        spos = jax.vmap(jax.vmap(lambda r, lo, hi: ref_sampling.sample_indices(r, m, lo, hi)))(
            rngs, off1[:, :-1], off1[:, 1:])
        svals = jnp.sort(jnp.take_along_axis(a1["k"], spos.reshape(B, nb1 * m), axis=1)
                         .reshape(B, nb1, m), axis=-1)
        spl.append(ref_sampling.select_splitters(svals, k2))
    return [to_port(np.asarray(s)) for s in spl]


@pytest.mark.parametrize("classifier,dist,dtype,n", [
    ("tree", "RootDup", np.int32, 3000),  # two levels
    ("radix", "Uniform", np.float32, 500),  # one level
    ("radix", "RootDup", np.int32, 3000),
])
def test_batched_partition_passes_match_reference(classifier, dist, dtype, n):
    ref_cfg, cfg = _configs(classifier)
    B = 3
    u = ref_keyspace.encode_np(make_input(dist, B * n, dtype, seed=6)).reshape(B, n)
    n_pad = -(-n // 256) * 256
    u_pad = np.concatenate([u, np.full((B, n_pad - n), UMAX, np.uint32)], 1)
    levels = ips4o.plan_levels(n_pad, cfg)
    assert len(levels) == (1 if n == 500 else 2)
    want, want_off, want_nb, want_pad = ref_ips4o.batched_partition_passes(
        {"k": jnp.asarray(u_pad)}, n, ref_cfg, levels)
    # radix samples nothing, so its offsets match with nothing fed in
    spl = _reference_splitters(u_pad, n, ref_cfg, levels) if classifier == "tree" else None
    arrays = ips4o.batched_pad_with_sentinel({"k": to_port(u)}, 256)
    out, off, nb, pad_bucket = ips4o.batched_partition_passes(arrays, n, cfg, levels, spl)
    assert (nb, pad_bucket) == (want_nb, want_pad)
    np.testing.assert_array_equal(off.numpy(), np.asarray(want_off))
    np.testing.assert_array_equal(to_ref(out["k"]), np.asarray(want["k"]))
    assert bool(ips4o.batched_bucket_violations(off, nb, 256, pad_bucket)) == bool(
        ref_ips4o.batched_bucket_violations(want_off, want_nb, 256, want_pad))


# ---------------------------------------------------------------------------
# the batched ops, end to end


@pytest.mark.parametrize("n", [500, 3000])  # one level / two levels
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("classifier", ["tree", "radix"])
def test_batched_ops_match_reference(classifier, dtype, n):
    ref_cfg, cfg = _configs(classifier)
    check_batched(_rows(n, dtype), ref_cfg, cfg)


@pytest.mark.parametrize("classifier", ["tree", "radix"])
def test_one_row_equals_the_1d_op(classifier):
    _, cfg = _configs(classifier)
    x = make_input("Exponential", 3001, np.float32, seed=2)  # n not a multiple of W
    t = torch.as_tensor(x)
    np.testing.assert_array_equal(
        ops.batched_argsort(t[None], cfg=cfg, device="cpu")[0].numpy(),
        ops.argsort(t, cfg=cfg, device="cpu").numpy())
    for bop, op in ((ops.batched_topk, ops.topk), (ops.batched_bottomk, ops.bottomk)):
        bv, bi = bop(t[None], 50, cfg=cfg, device="cpu")
        v, i = op(t, 50, cfg=cfg, device="cpu")
        np.testing.assert_array_equal(bi[0].numpy(), i.numpy())
        np.testing.assert_array_equal(bits(bv[0].numpy()), bits(v.numpy()))


@pytest.mark.parametrize("shape", [(0, 5), (3, 1), (3, 0), (2, 200)])
def test_batched_degenerate_shapes_and_large_k(shape):
    ref_cfg, cfg = _configs("tree")
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    n = shape[1]
    want = np.asarray(ref_ops.batched_argsort(jnp.asarray(x), cfg=ref_cfg))
    got = ops.batched_argsort(torch.as_tensor(x), cfg=cfg, device="cpu")
    assert got.shape == want.shape and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    got_k = ops.batched_sort(torch.as_tensor(x), cfg=cfg, device="cpu")
    np.testing.assert_array_equal(got_k.numpy(),
                                  np.asarray(ref_ops.batched_sort(jnp.asarray(x), cfg=ref_cfg)))
    for k in (0, n + 3):  # k >= n degrades to the full sort
        for op, ref_op in ((ops.batched_topk, ref_ops.batched_topk),
                           (ops.batched_bottomk, ref_ops.batched_bottomk)):
            want_v, want_i = ref_op(jnp.asarray(x), k, cfg=ref_cfg)
            got_v, got_i = op(torch.as_tensor(x), k, cfg=cfg, device="cpu")
            assert got_v.shape == want_v.shape and got_i.shape == want_i.shape
            np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
            np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_batched_sort_moves_a_payload():
    _, cfg = _configs("radix")
    x = make_input("TwoDup", 2 * 1000, np.int32, seed=5).reshape(2, 1000)
    vals = torch.arange(2000, dtype=torch.int64).reshape(2, 1000) * 3
    k, v = ops.batched_sort(torch.as_tensor(x), vals, cfg=cfg, device="cpu")
    order = np.argsort(x, axis=1, kind="stable")
    np.testing.assert_array_equal(k.numpy(), np.take_along_axis(x, order, 1))
    np.testing.assert_array_equal(v.numpy(), np.take_along_axis(vals.numpy(), order, 1))


def test_batched_entry_points_check_their_inputs(monkeypatch):
    x2 = torch.zeros((2, 10))
    with pytest.raises(ValueError, match="batched_sort"):
        ops.sort(x2, device="cpu")
    with pytest.raises(ValueError, match="2-D"):
        ops.batched_sort(torch.zeros(10), device="cpu")
    with pytest.raises(ValueError, match="2-D"):
        ops.batched_topk(torch.zeros(10), 2, device="cpu")
    # the reference's signature (cfg, engine, keys, classifier); the port has
    # no engine, so only None passes
    assert ops.with_engine_batched(ips4o.SortConfig(), classifier="radix").classifier == "radix"
    assert ops.with_engine_batched(ips4o.SortConfig(classifier="radix")).classifier == "radix"
    assert ops.with_engine_batched(ips4o.SortConfig(), None, x2, "auto").classifier == "tree"
    with pytest.raises(ValueError, match="engine"):
        ops.with_engine_batched(ips4o.SortConfig(), "pallas")
    with pytest.raises(ValueError, match="classifier"):
        ops.batched_sort(x2, classifier="neural", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.batched_sort(torch.zeros((2, 10), dtype=torch.complex64), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.batched_argsort(x2)
