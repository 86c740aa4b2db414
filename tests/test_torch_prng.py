"""The port's threefry keys (``testground_tpu_torch/sim/prng.py``) against
``jax.random`` itself: ``key``, ``split`` (2 and n), batched ``fold_in``
and ``key_data``, bit for bit, under jax's default
``jax_threefry_partitionable=True`` layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from testground_tpu_torch.sim import prng

SEEDS = [0, 1, 2, 3, 7, 11, 42, 99, 123, 255, 256, 1000, 4096, 65535, 65536,
         10**6, 2**24 + 5, 2**30, 2**31 - 1, -1, -7, 31337, 8675309, 271828]


def _kd(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_match_jax(seed):
    k = jax.random.key(seed)
    mk = prng.key(seed)
    np.testing.assert_array_equal(prng.key_data(mk).numpy(), _kd(k))
    a, b = jax.random.split(k)
    np.testing.assert_array_equal(
        prng.split(mk).numpy(), np.stack([_kd(a), _kd(b)])
    )
    ha, hb = prng.split_host(tuple(int(x) for x in mk))
    assert [list(ha), list(hb)] == [_kd(a).tolist(), _kd(b).tolist()]
    np.testing.assert_array_equal(
        prng.fold_in(mk, seed & 0xFFFF).numpy(),
        _kd(jax.random.fold_in(k, seed & 0xFFFF)),
    )


@pytest.mark.parametrize("num", [1, 2, 3, 5, 16, 17, 100, 1000])
def test_split_n_matches_jax(num):
    k = jax.random.key(5)
    np.testing.assert_array_equal(
        prng.split(prng.key(5), num).numpy(), _kd(jax.random.split(k, num))
    )


@pytest.mark.parametrize("tick", [0, 1, 2, 63, 64, 1000, 2**31 - 1])
@pytest.mark.parametrize("n", [1, 7, 16])
def test_batched_fold_in_matches_vmapped_jax(n, tick):
    """The engine's per-instance key fold (``engine.py:1106``): one tick
    folded into every instance key, as a 0-d int32 tensor like the tick
    counter the engine carries."""
    keys = jax.random.split(jax.random.key(9), n)
    want = _kd(
        jax.vmap(jax.random.fold_in)(keys, jnp.broadcast_to(jnp.int32(tick), (n,)))
    )
    got = prng.fold_in(
        torch.from_numpy(_kd(keys)), torch.tensor(tick, dtype=torch.int32)
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_key_schedule_matches_jax():
    """``init_carry``'s root → (net_key, instance root) → per-instance
    keys, then the per-tick link-key advance, for 20 ticks."""
    root = jax.random.key(17)
    net_key, inst_root = jax.random.split(root)
    keys = jax.random.split(inst_root, 10)
    m_net, m_inst = prng.split(prng.key(17))
    np.testing.assert_array_equal(prng.split(m_inst, 10).numpy(), _kd(keys))
    host = tuple(int(x) for x in m_net)
    for _ in range(20):
        net_key, k_msg = jax.random.split(net_key)
        host, h_msg = prng.split_host(host)
        assert list(host) == _kd(net_key).tolist()
        assert list(h_msg) == _kd(k_msg).tolist()


def _inst_keys(seed, n):
    """A batch of per-instance keys, as ``init_carry`` derives them."""
    return jax.random.split(jax.random.split(jax.random.key(seed))[1], n)


@pytest.mark.parametrize("seed", SEEDS)
def test_batched_split_and_random_bits_match_jax(seed):
    """``split`` over a ``[n, 2]`` batch (storm splits ``env.key`` per
    instance at init) and 32-bit ``random_bits``."""
    keys = _inst_keys(seed, 6)
    kd = torch.from_numpy(_kd(keys))
    np.testing.assert_array_equal(
        prng.split(kd).numpy(), _kd(jax.vmap(jax.random.split)(keys)))
    np.testing.assert_array_equal(
        prng.split(kd, 3).numpy(), _kd(jax.vmap(lambda k: jax.random.split(k, 3))(keys)))
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (2, 5)))(keys)).astype(np.int64)
    np.testing.assert_array_equal(prng.random_bits(kd, (2, 5)).numpy(), want)


N_STORM = 16
SPANS = [(0, 1), (0, 2), (0, 7), (0, N_STORM - 1), (0, 2**31 - 1), (-5, 3),
         (9, 9), (7, 2), (-(2**31), 2**31 - 1)]


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_matches_jax(seed):
    """``randint`` as ``jax._src.random._randint`` computes it for int32,
    over spans 1, 2, 7, n-1 and 2^31-1 (plus negative, empty and inverted
    ranges, and the full int32 range, where the uint32 arithmetic wraps)."""
    keys = _inst_keys(seed, 5)
    kd = torch.from_numpy(_kd(keys))
    for lo, hi in SPANS:
        want = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (8,), lo, hi))(keys))
        got = prng.randint(kd, (8,), lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"[{lo}, {hi})")


def test_storm_init_draws_match_jax():
    """The storm plan's init draws for one group: ``split(env.key)``, then
    ``randint`` of targets in ``[0, max(n-1, 1))`` shifted past the own
    index and of delays in ``[0, 32)``, per instance."""
    n, out = N_STORM, 5
    keys = _inst_keys(3, n)

    def draw(k, seq):
        k_t, k_d = jax.random.split(k)
        tg = jax.random.randint(k_t, (out,), 0, jnp.maximum(n - 1, 1))
        return tg + (tg >= seq), jax.random.randint(k_d, (out,), 0, 32)

    want_t, want_d = jax.vmap(draw)(keys, jnp.arange(n, dtype=jnp.int32))
    ks = prng.split(torch.from_numpy(_kd(keys)))
    tg = prng.randint(ks[:, 0], (out,), 0, n - 1)
    tg = tg + (tg >= torch.arange(n, dtype=torch.int32)[:, None])
    np.testing.assert_array_equal(tg.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(prng.randint(ks[:, 1], (out,), 0, 32).numpy(),
                                  np.asarray(want_d))
