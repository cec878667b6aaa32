"""The port's exchange modules (plain path, CPU, one process) against the
JAX package's.

`exchange/partition.py` at P = 3, 4 and 8 (a power of two hides a wrong
unsigned remainder, so P = 3 too) on int32, int64, uint32, uint64, float32
and float64 keys, with empty shards and all-sentinel samples; the exchange
as `pack_buckets` -> `exchange_local` -> `compact_received` against
`all_to_all_exchange` under `jax.shard_map` on a P-device CPU mesh, for
every ``num_chunks``, with a bucket that overflows; `exchange/skew.py`,
its two collectives through a test-only all-gather over the P ranks'
inputs. Keys reach the port as order keys (`columnar/dtypes.order_key`),
so the JAX package's keys are compared through the same map. Exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import pim_sort_merge_join_tpu  # noqa: F401  (64-bit JAX)
from pim_sort_merge_join_tpu.columnar.table import key_sentinel as jax_sentinel
from pim_sort_merge_join_tpu.exchange import partition as jpart
from pim_sort_merge_join_tpu.exchange import skew as jskew
from pim_sort_merge_join_tpu.exchange.shuffle import all_to_all_exchange
from pim_sort_merge_join_tpu_torch.columnar import dtypes
from pim_sort_merge_join_tpu_torch.exchange import partition, shuffle, skew

TYPES = ["int32", "int64", "uint32", "uint64", "float32", "float64"]
PS = [3, 4, 8]


def _mesh(p):
    return Mesh(np.array(jax.devices()[:p]), ("p",))


def _keys(rng, dtype: str, n: int) -> np.ndarray:
    """Keys of ``dtype`` with repeats and the type's edges (no NaN)."""
    dt = np.dtype(dtype)
    if dt.kind == "f":
        pool = np.concatenate([rng.normal(0, 1e3, 40), [-0.0, 0.0, -np.inf, 1.5, -1.5,
                                                          np.finfo(dt).max, np.finfo(dt).tiny]])
    else:
        info = np.iinfo(dt)
        pool = [int(v) for v in rng.integers(max(info.min, -(10**6)), 10**6, 40)]
        pool = np.array(pool + [int(info.min), int(info.max) - 1, 0, 1], dtype=dt)
    return rng.choice(pool, n).astype(dt)


def _order(a) -> torch.Tensor:
    return dtypes.order_key(torch.from_numpy(np.array(a)))


def _masked(keys: np.ndarray, num_valid: int) -> np.ndarray:
    out = keys.copy()
    out[num_valid:] = np.asarray(jax_sentinel(keys.dtype))
    return out


@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("num_valid", [0, 5, 200])
def test_sample_keys(dtype, num_valid):
    keys = _masked(_keys(np.random.default_rng(1), dtype, 200), num_valid)
    want = jpart.sample_keys(jnp.asarray(keys), jnp.int32(num_valid), 64)
    got = partition.sample_keys(_order(keys), torch.tensor(num_valid, dtype=torch.int32), 64)
    assert torch.equal(got, _order(want))


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("dtype", TYPES)
def test_splitters_and_destinations(p, dtype):
    """Pooled samples of p ranks' two tables, one rank empty, then every
    row's range and hash destination."""
    rng = np.random.default_rng(p)
    counts = [0] + [int(c) for c in rng.integers(1, 300, 2 * p - 1)]
    shards = [_masked(_keys(rng, dtype, 300), c) for c in counts]
    jsmp = [jpart.sample_keys(jnp.asarray(s), jnp.int32(c), 32) for s, c in zip(shards, counts)]
    psmp = [partition.sample_keys(_order(s), torch.tensor(c), 32) for s, c in zip(shards, counts)]
    jspl = jpart.choose_splitters(jnp.concatenate(jsmp), p)
    pspl = partition.choose_splitters(torch.cat(psmp), p)
    assert torch.equal(pspl, _order(jspl))
    keys = _keys(rng, dtype, 500)
    valid = rng.random(500) < 0.8
    jdest = jpart.destination_of(jnp.asarray(keys), jspl, jnp.asarray(valid))
    pdest = partition.destination_of(_order(keys), pspl, torch.from_numpy(valid))
    assert pdest.dtype == torch.int32
    np.testing.assert_array_equal(pdest.numpy(), np.asarray(jdest))
    jh = jpart.hash_destination_of(jnp.asarray(keys), p, jnp.asarray(valid))
    ph = partition.hash_destination_of(torch.from_numpy(keys), p, torch.from_numpy(valid))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    assert set(np.unique(ph.numpy()[valid])) <= set(range(p))


@pytest.mark.parametrize("p", PS)
def test_all_sentinel_sample(p):
    pooled = np.full(96, np.iinfo(np.int64).max, np.int64)
    jspl = jpart.choose_splitters(jnp.asarray(pooled), p)
    pspl = partition.choose_splitters(torch.from_numpy(pooled), p)
    assert torch.equal(pspl, _order(jspl))
    keys = np.array([1, -5, 2**40, np.iinfo(np.int64).max], np.int64)
    valid = np.array([True, True, True, False])
    np.testing.assert_array_equal(
        partition.destination_of(torch.from_numpy(keys), pspl, torch.from_numpy(valid)).numpy(),
        np.asarray(jpart.destination_of(jnp.asarray(keys), jspl, jnp.asarray(valid))))


@pytest.mark.parametrize("p", [3, 5, 7, 1000003])
def test_unsigned_remainder_of_64_bit_hashes(p):
    rng = np.random.default_rng(p)
    h = np.concatenate([rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 1000,
                                     dtype=np.int64), [-1, 0, 1, np.iinfo(np.int64).min]])
    want = (h.view(np.uint64) % np.uint64(p)).astype(np.int64)
    np.testing.assert_array_equal(partition.unsigned_remainder(torch.from_numpy(h), p).numpy(),
                                  want)


def test_nan_keys_follow_the_order_key():
    """The pinned divergence (ROADMAP §3): the reference sorts NaN after
    +inf and counts it as a valid sample, and searches NaN to rank 0; the
    port's order key makes NaN the sentinel, so it is no sample and goes
    where +inf goes. Rows with NaN keys never join in either package."""
    keys = np.array([1.0, np.nan, 2.0, np.nan, 3.0, np.inf], np.float64)
    jspl = jpart.choose_splitters(jnp.asarray(keys), 3)
    pspl = partition.choose_splitters(_order(keys), 3)
    assert np.isnan(np.asarray(jspl)).sum() == 0 and np.asarray(jspl).tolist() == [2.0, np.inf]
    assert dtypes.from_order_key(pspl, torch.float64).tolist() == [2.0, 3.0]
    valid = np.ones(6, bool)
    jdest = np.asarray(jpart.destination_of(jnp.asarray(keys), jspl, jnp.asarray(valid)))
    pdest = partition.destination_of(_order(keys), pspl, torch.from_numpy(valid)).numpy()
    assert jdest.tolist() == [0, 2, 0, 2, 1, 1]
    assert pdest.tolist() == [0, 2, 0, 2, 1, 2]


def _jax_exchange(data, dest, p, bucket, recv, k):
    def body(d, t):
        res = all_to_all_exchange(d, t, "p", bucket_capacity=bucket, recv_capacity=recv,
                                  num_chunks=k)
        return res.data, res.num_rows.reshape(1), res.true_rows.reshape(1)

    out = jax.jit(jax.shard_map(body, mesh=_mesh(p), in_specs=(P("p", None), P("p")),
                                out_specs=(P("p", None), P("p"), P("p")), check_vma=False))(
        jnp.asarray(data), jnp.asarray(dest))
    return tuple(np.asarray(o) for o in out)


def _port_exchange(data, dest, p, bucket, recv):
    cap = data.shape[0] // p
    packs = [shuffle.pack_buckets(torch.from_numpy(data[r * cap:(r + 1) * cap]),
                                  torch.from_numpy(dest[r * cap:(r + 1) * cap]), p, bucket)
             for r in range(p)]
    got = [shuffle.compact_received(b.blocks, b.counts, recv, torch.from_numpy(data).dtype)
           for b in shuffle.exchange_local(packs)]
    return (np.concatenate([g.data.numpy() for g in got]),
            np.array([int(g.num_rows) for g in got], np.int32),
            np.array([int(g.true_rows) for g in got], np.int32))


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("dtype", ["int64", "uint64", "float64", "int32"])
def test_exchange_equals_all_to_all_exchange(p, dtype):
    rng = np.random.default_rng(p)
    cap = 24
    data = _keys(rng, dtype, p * cap * 3).reshape(p * cap, 3)
    dest = rng.integers(0, p + 2, p * cap).astype(np.int32)  # >= p: dropped
    got = _port_exchange(data, dest, p, 16, 40)
    # num_chunks only changes how the reference moves the payload.
    for k in (1, 2, 4, 16) if dtype == "int64" else (1,):
        want = _jax_exchange(data, dest, p, 16, 40, k)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


@pytest.mark.parametrize("p", PS)
def test_exchange_overflow_reports_true_rows(p):
    cap = 16
    data = np.arange(p * cap * 2, dtype=np.int64).reshape(p * cap, 2)
    dest = np.zeros(p * cap, np.int32)  # every row to rank 0
    got = _port_exchange(data, dest, p, 4, 3 * p)
    want = _jax_exchange(data, dest, p, 4, 3 * p, 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2][0] == p * cap and got[1][0] == 3 * p  # true demand > what was kept


@pytest.mark.parametrize("dtype", TYPES)
def test_heavy_hitters(dtype):
    rng = np.random.default_rng(5)
    keys = _keys(rng, dtype, 300)
    keys[rng.random(300) < 0.3] = keys[0]
    keys[rng.random(300) < 0.15] = keys[1]
    pooled = _masked(keys, 260)
    for frac, k_max in ((0.1, 4), (0.2, 2), (1.0, 3)):
        jh = jskew.detect_heavy_hitters(jnp.asarray(pooled), frac, k_max)
        ph = skew.detect_heavy_hitters(_order(pooled), frac, k_max)
        assert torch.equal(ph, _order(jh))
        assert torch.equal(skew.mask_heavy_samples(_order(pooled), ph),
                           _order(jskew.mask_heavy_samples(jnp.asarray(pooled), jh)))
        valid = rng.random(300) < 0.9
        ji, js = jskew.heavy_slot_of(jnp.asarray(keys), jh, jnp.asarray(valid))
        pi, ps = skew.heavy_slot_of(_order(keys), ph, torch.from_numpy(valid))
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


@pytest.mark.parametrize("fraction,p", [(0.2, 3), (0.1, 4), (0.5, 8), (1.0, 4)])
def test_max_heavy_hitters(fraction, p):
    assert skew.max_heavy_hitters(fraction, p) == jskew.max_heavy_hitters(fraction, p)


class _Ranks:
    """A test-only stand-in for `exchange/collectives.py` over P ranks in
    one process: a first pass records what each rank gives every
    all-gather, a second answers each with all ranks' contributions."""

    def __init__(self, p):
        self.p, self.me, self.given, self.calls = p, 0, {}, 0

    def world_size(self, group=None):
        return self.p

    def rank(self, group=None):
        return self.me

    def all_gather(self, x, group=None):
        key = (self.me, self.calls)
        self.calls += 1
        if self.recording:
            self.given[key] = x.clone()
            return torch.stack([x] * self.p)
        return torch.stack([self.given[(r, key[1])] for r in range(self.p)])

    def run(self, fn, monkeypatch):
        monkeypatch.setattr(skew, "collectives", self)
        out = []
        for self.recording in (True, False):
            out = []
            for self.me in range(self.p):
                self.calls = 0
                out.append(fn(self.me))
        return out


@pytest.mark.parametrize("p", PS)
def test_heavy_rank_destination(p, monkeypatch):
    rng = np.random.default_rng(p)
    cap, k_max = 40, 3
    is_heavy = rng.random(p * cap) < 0.6
    slot = rng.integers(0, k_max, p * cap).astype(np.int32)
    want = np.asarray(jax.jit(jax.shard_map(
        lambda h, s: jskew.heavy_rank_destination(h, s, k_max, "p"), mesh=_mesh(p),
        in_specs=(P("p"), P("p")), out_specs=P("p"), check_vma=False))(
        jnp.asarray(is_heavy), jnp.asarray(slot)))
    got = _Ranks(p).run(lambda r: skew.heavy_rank_destination(
        torch.from_numpy(is_heavy[r * cap:(r + 1) * cap]),
        torch.from_numpy(slot[r * cap:(r + 1) * cap]), k_max), monkeypatch)
    np.testing.assert_array_equal(np.concatenate([g.numpy() for g in got])[is_heavy],
                                  want[is_heavy])


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("capacity", [3, 16])
def test_gather_heavy_side(p, capacity, monkeypatch):
    rng = np.random.default_rng(p + capacity)
    cap = 20
    data = rng.integers(0, 1000, (p * cap, 3)).astype(np.int64)
    is_heavy = rng.random(p * cap) < 0.4
    want = jax.jit(jax.shard_map(
        lambda d, h: tuple(x[None] if x.ndim == 0 else x for x in
                           jskew.gather_heavy_side(d, h, "p", capacity=capacity)),
        mesh=_mesh(p), in_specs=(P("p", None), P("p")),
        out_specs=(P("p", None), P("p"), P("p")), check_vma=False))(
        jnp.asarray(data), jnp.asarray(is_heavy))
    rows, valid, true = (np.asarray(w) for w in want)
    got = _Ranks(p).run(lambda r: skew.gather_heavy_side(
        torch.from_numpy(data[r * cap:(r + 1) * cap]),
        torch.from_numpy(is_heavy[r * cap:(r + 1) * cap]), capacity=capacity), monkeypatch)
    n = p * capacity
    for r, (g_rows, g_valid, g_true) in enumerate(got):
        np.testing.assert_array_equal(g_rows.numpy(), rows[r * n:(r + 1) * n])
        np.testing.assert_array_equal(g_valid.numpy(), valid[r * n:(r + 1) * n])
        assert int(g_true) == true[r]


def test_sample_positions_past_the_int32_product():
    """The pinned divergence (ROADMAP §3): the reference takes sample
    position ``s * num_valid // S`` in int32, which wraps once ``s *
    num_valid >= 2^31`` (2.1M valid rows at S = 1024), so its last samples
    come from the head of the table again; the port takes the exact
    positions."""
    n, size = 2_200_000, 1024
    keys = np.arange(n, dtype=np.int64)
    exact = (np.arange(size, dtype=np.int64) * n) // size
    want = np.asarray(jpart.sample_keys(jnp.asarray(keys), jnp.int32(n), size))
    got = partition.sample_keys(torch.from_numpy(keys), torch.tensor(n, dtype=torch.int32), size)
    np.testing.assert_array_equal(got.numpy(), exact)
    wrapped = np.arange(size) * n >= 2**31
    np.testing.assert_array_equal(want[~wrapped], exact[~wrapped])
    assert wrapped.sum() == 47 and (want[wrapped] < exact[wrapped]).all()
