"""The port's associative segment scan (``engine/sim.py::simulate_occasion_assoc``,
``Analytical.with_scan``) and the Pmetrics padded-layout wrappers
(``engine/analytical.py::pm_wrap`` and the twelve ``pm_*`` aliases).

Float64 on the CPU, on numpy-seeded inputs: ``pm_wrap`` of every kernel
against the JAX package's (1e-14); ``with_scan('associative')`` against the
port's serial march (1e-10: the same closed forms composed in another
order) and against the JAX package's associative scan on a short regimen
(predictions, psi and the per-subject batch, 1e-10); the refusals with the
JAX messages. The JAX package's long regimen
(``test_analytical_engine.py:346``) runs on the port, and against the JAX
package's scan under ``slow``, as it does there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.engine import analytical as jax_analytical
from pharmsol_tpu.likelihood.matrix import log_likelihood_batch as jax_batch
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.engine import analytical
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.likelihood.matrix import log_likelihood_batch, log_likelihood_matrix

REL = 1e-10
P2 = [0.15, 1.2, 0.3, 0.2, 10.0]


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel, atol=1e-300)


@pytest.mark.parametrize("name", sorted(analytical.KERNELS))
def test_pm_wrap_pads_slot_zero(name):
    fn, nstates, nparams = analytical.KERNELS[name]
    rng = np.random.RandomState(len(name))
    x = np.concatenate([[1234.0], 10.0 + 50.0 * rng.rand(nstates)])
    r = np.concatenate([[5678.0], [3.0]])
    p = 0.05 + 0.5 * rng.rand(nparams)
    pm = getattr(analytical, f"pm_{name}")
    assert pm.__name__ == f"pm_{name}"
    out = pm(torch.as_tensor(x), torch.as_tensor(p), 1.5, torch.as_tensor(r))
    assert out[0] == 0.0
    ref = fn(torch.as_tensor(x[1:]), torch.as_tensor(p), 1.5, torch.as_tensor(r[1:]))
    close(out[1:], ref, 1e-14)
    jax_pm = jax_analytical.pm_wrap(jax_analytical.KERNELS[name][0])
    close(out, jax_pm(jnp.asarray(x), jnp.asarray(p), 1.5, jnp.asarray(r)), 1e-14)
    assert "pm_wrap" in analytical.__all__


def _subjects(lib, n=3, seed=41):
    """A short mixed regimen: two boluses, an infusion, 6 observations, a
    second occasion on the last subject."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        b = lib.Subject.builder(f"a{i}").bolus(0.0, 100.0, 0).bolus(12.0, 80.0, 0)
        b = b.infusion(3.0, 50.0, 0, 2.0)
        for t in (0.5, 2.0, 4.0, 8.0, 13.0, 20.0):
            b = b.observation(t, float(abs(5 + rng.randn())), 0)
        if i == n - 1:
            b = b.reset().bolus(0.0, 60.0, 0).observation(2.0, 3.0, 0)
        out.append(b.build())
    return lib.Data(out)


def _model(lib, scan=None, lag=None):
    m = lib.Analytical(lib.two_compartments_with_absorption,
                       out=lambda x, p, t, cov: x[1:2] / p[4], lag=lag,
                       nstates=3, ndrugs=1, nout=1)
    return m.with_scan(scan) if scan else m


def _ems(lib):
    return lib.AssayErrorModels().add(
        0, lib.AssayErrorModel.additive(lib.ErrorPoly(0.5, 0.1), 1.0))


def _support(n, seed=7):
    rng = np.random.RandomState(seed)
    return np.abs(np.asarray(P2)[None, :] * (1.0 + 0.2 * rng.randn(n, 5)))


def test_associative_scan_matches_serial_and_jax():
    data, jdata = _subjects(pt), _subjects(pst)
    sp = _support(5)
    assoc = _model(pt, "associative")
    serial = _model(pt)
    got = log_likelihood_matrix(assoc, data, sp, _ems(pt), engine="general")
    close(got, log_likelihood_matrix(serial, data, sp, _ems(pt), engine="general"))
    close(got, jax_psi(_model(pst, "associative"), jdata, sp, _ems(pst)))
    # predictions and the per-subject batch take the scan too
    subject = data.subjects()[0]
    pa = assoc.estimate_predictions(subject, P2).flat_predictions()
    close(pa, serial.estimate_predictions(subject, P2).flat_predictions())
    jm = _model(pst, "associative")
    close(pa, jm.estimate_predictions(jdata.subjects()[0], P2).flat_predictions())
    rems = {lib: lib.ResidualErrorModels().add(0, lib.ResidualErrorModel.combined(0.3, 0.1))
            for lib in (pt, pst)}
    params = _support(len(data), 9)
    close(log_likelihood_batch(assoc, data, params, rems[pt]),
          jax_batch(jm, jdata, params, rems[pst]))


def test_associative_scan_with_lag_and_init():
    """Per-support segments (lag) and an occasion-0 state (init)."""
    def lag(p, t, cov):
        return {0: 0.1 * p[0]}

    data = _subjects(pt, n=2)
    sp = _support(4, 3)
    serial = pt.Analytical(pt.two_compartments_with_absorption,
                           out=lambda x, p, t, cov: x[1:2] / p[4], lag=lag,
                           init=lambda p, t, cov: torch.stack([p[4] * 0.0, p[4] * 0.2,
                                                               p[4] * 0.0]),
                           nstates=3, ndrugs=1, nout=1)
    want = log_likelihood_matrix(serial, data, sp, _ems(pt), engine="general")
    got = log_likelihood_matrix(serial.with_scan("associative"), data, sp, _ems(pt),
                                engine="general")
    close(got, want)


def test_associative_scan_rejects_seq_models():
    m = pt.Analytical(pt.one_compartment, seq_eq=lambda p, t, cov: p,
                      out=lambda x, p, t, cov: x[:1] / p[1], nstates=1, ndrugs=1, nout=1)
    with pytest.raises(PharmsolError, match="affine propagator: models with a seq "
                                            "equation must use the serial scan"):
        m.with_scan("associative")
    with pytest.raises(PharmsolError, match="scan mode must be 'serial' or 'associative'"):
        pt.Analytical(pt.one_compartment, out=lambda x, p, t, cov: x[:1],
                      nstates=1, ndrugs=1, nout=1).with_scan("butterfly")


def _long_regimen(lib):
    """The JAX package's long regimen (``test_analytical_engine.py:346``):
    q12h x 10 boluses, two infusions, 25 observations and a BLOQ one, a
    second occasion; and its support."""
    rng = np.random.RandomState(41)
    b = lib.Subject.builder("assoc")
    for d in range(10):
        b = b.bolus(d * 12.0, 100.0, 0)
    b = b.infusion(3.0, 50.0, 0, 2.0).infusion(60.0, 80.0, 0, 4.0)
    for t in np.linspace(0.5, 118.0, 25):
        b = b.observation(float(t), float(np.abs(5 + rng.randn())), 0)
    b = b.censored_observation(119.0, 0.5, 0, lib.Censor.BLOQ)
    subject = b.reset().bolus(0.0, 60.0, 0).observation(2.0, 3.0, 0).build()
    return subject, np.abs(np.asarray(P2)[None, :] * (1.0 + 0.2 * rng.randn(11, 5)))


def test_associative_scan_matches_serial_long_regimen():
    subject, support = _long_regimen(pt)
    serial, assoc = _model(pt), _model(pt, "associative")
    close(assoc.estimate_predictions(subject, P2).flat_predictions(),
          serial.estimate_predictions(subject, P2).flat_predictions())
    close(log_likelihood_matrix(assoc, pt.Data([subject]), support, _ems(pt)),
          log_likelihood_matrix(serial, pt.Data([subject]), support, _ems(pt)), 1e-9)


@pytest.mark.slow
def test_associative_scan_long_regimen_matches_jax():
    """The long regimen against the JAX package's associative scan."""
    subject, support = _long_regimen(pt)
    jsubject, _ = _long_regimen(pst)
    jm = _model(pst, "associative")
    close(_model(pt, "associative").estimate_predictions(subject, P2).flat_predictions(),
          jm.estimate_predictions(jsubject, P2).flat_predictions())
    close(log_likelihood_matrix(_model(pt, "associative"), pt.Data([subject]), support,
                                _ems(pt)),
          jax_psi(jm, pst.Data([jsubject]), support, _ems(pst)), 1e-9)
