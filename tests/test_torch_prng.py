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
