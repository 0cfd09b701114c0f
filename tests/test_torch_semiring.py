"""Port semirings vs the JAX package's: identities and mul, all 8 entries."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from combblas_tpu import semiring as jsr  # noqa: E402
from combblas_tpu_torch import semiring as tsr  # noqa: E402

NAMES = sorted(jsr._REGISTRY)


def test_registry_names_match():
    assert sorted(tsr._REGISTRY) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_semiring_matches_jax(name):
    js, ts = jsr.get_semiring(name), tsr.get_semiring(name)
    assert ts.add_kind == js.add_kind
    assert tsr.ADD_CODES[ts.add_kind] == ts.add_code
    for np_dt, t_dt in ((np.float32, torch.float32),
                        (np.int32, torch.int32),
                        (np.int64, torch.int64)):
        jz = np.asarray(js.zero(np_dt))
        tz = ts.zero(t_dt)
        assert tz.dtype == t_dt
        np.testing.assert_array_equal(tz.numpy(), jz)
    rng = np.random.default_rng(3)
    a = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    a[::5] = 0.0
    b[::7] = 0.0
    jm = np.asarray(js.mul(jnp.asarray(a), jnp.asarray(b)))
    tm = ts.mul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert tm.dtype == np.float32
    np.testing.assert_array_equal(tm.view(np.int32), jm.view(np.int32))
    ja = np.asarray(js.add(jnp.asarray(a), jnp.asarray(b)))
    ta = ts.add(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(ta, ja)


def test_bool_max_identity_and_or_and_codes():
    assert not bool(tsr.OR_AND.zero(torch.bool))
    assert tsr.OR_AND.mul_code == tsr.MUL_CODES["and"]
    assert sorted(tsr.MUL_CODES.values()) == list(range(5))
    assert sorted(tsr.ADD_CODES.values()) == list(range(3))
    with pytest.raises(ValueError):
        tsr.Semiring("bad", "prod", "times")
