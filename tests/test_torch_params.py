"""The port's params and tables against tpu_ntt's.

tpu_ntt_torch keeps pure-Python copies of ``params`` and ``tables`` (it may
not import tpu_ntt, which imports JAX).  Tolerance: none — every constant and
every twiddle must be the same integer.
"""

import numpy as np
import pytest

import tpu_ntt.params as jparams
import tpu_ntt.tables as jtables
import tpu_ntt_torch.params as tparams
import tpu_ntt_torch.tables as ttables

Q60 = jparams.P60_4096.q

FIELDS = ("n", "q", "psi", "name", "log_n", "width", "omega", "psi_inv",
          "omega_inv", "n_inv", "barrett_k", "barrett_mu", "mont_bits",
          "mont_r", "mont_q_prime", "mont_r_mod_q", "mont_r2_mod_q")


def test_same_presets_and_reductions():
    assert list(tparams.PRESETS) == list(jparams.PRESETS)
    assert ([r.value for r in tparams.Reduction]
            == [r.value for r in jparams.Reduction])


@pytest.mark.parametrize("name", list(jparams.PRESETS))
def test_preset_constants_match(name):
    mine, ref = tparams.PRESETS[name], jparams.PRESETS[name]
    for field in FIELDS:
        assert getattr(mine, field) == getattr(ref, field), field
    assert mine.to_mont(12345) == ref.to_mont(12345)
    mine.validate_roots()


@pytest.mark.parametrize("n,q", [(256, Q60), (8192, Q60), (1024, 12289),
                                 (512, 998244353), (256, 576460752308273153)])
def test_make_params_matches(n, q):
    mine, ref = tparams.make_params(n, q), jparams.make_params(n, q)
    for field in FIELDS:
        assert getattr(mine, field) == getattr(ref, field), field
    assert tparams.find_psi(n, q) == jparams.find_psi(n, q)


@pytest.mark.parametrize("kwargs", [
    dict(n=3, q=97, psi=1),                    # n not a power of two
    dict(n=16, q=91, psi=1),                   # q composite
    dict(n=16, q=101, psi=1),                  # 2n does not divide q - 1
    dict(n=16, q=97, psi=1),                   # psi^n != -1
])
def test_invalid_params_rejected_alike(kwargs):
    with pytest.raises(ValueError):
        jparams.NttParams(**kwargs)
    with pytest.raises(ValueError):
        tparams.NttParams(**kwargs)


def test_primality_matches():
    rng = np.random.default_rng(7)
    cands = [0, 1, 2, 3, 4, 561, 1105, 8380417, Q60, Q60 + 2, (1 << 64) - (1 << 32) + 1]
    cands += [int(v) for v in rng.integers(1, 1 << 62, size=200)]
    for v in cands:
        assert tparams._is_probable_prime(v) == jparams._is_probable_prime(v), v


def test_twiddles_match_at_p60_4096():
    mine, ref = tparams.P60_4096, jparams.P60_4096
    assert ttables.psi_powers(mine) == jtables.psi_powers(ref)
    assert ttables.psi_inv_powers(mine) == jtables.psi_inv_powers(ref)
    for omega in (mine.omega, mine.omega_inv):
        assert np.array_equal(ttables.stage_twiddles(mine.n, omega, mine.q),
                              jtables.stage_twiddles(ref.n, omega, ref.q))


@pytest.mark.parametrize("name", ["dilithium_256", "falcon_512"])
def test_twiddles_match_small_presets(name):
    mine, ref = tparams.PRESETS[name], jparams.PRESETS[name]
    assert ttables.psi_powers(mine) == jtables.psi_powers(ref)
    assert ttables.psi_inv_powers(mine) == jtables.psi_inv_powers(ref)
    assert np.array_equal(ttables.stage_twiddles(mine.n, mine.omega, mine.q),
                          jtables.stage_twiddles(ref.n, ref.omega, ref.q))
