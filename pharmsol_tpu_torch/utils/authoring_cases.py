"""The models written through the authoring surfaces that ``chip_smoke.py``
phase 23 drives on the card and the CPU tests hold against the JAX package.

Each is DSL text or a call of the declarative API, buildable in either
package (``lib=`` the package, default this one), with no closure written
by hand:

- :data:`DSL_SHORT`: the 1-compartment oral closed form with its
  parameters declared in another order than the kernel's (``v, ke, ka``):
  kernel K1a on the remapped support;
- :data:`DSL_CREATININE`: ``ke = cl * pow(wt / 70.0, 0.75) / v`` with a
  time-varying ``wt``: kernel K1b through the kernel-input decomposition;
- :data:`DSL_ODE_SHORT`: the 2-compartment oral "Short" model as an ODE, in
  the parameter order of ``chip_smoke.py``'s closure (``ke, ka, kcp, kpc,
  v``): kernel K2a;
- :data:`DSL_POPULATION`: the population fit's 1-compartment oral model in
  the closure's order (``ka, ke, v``): K1a inside ``fit_population``;
- :data:`DSL_INTRINSICS`: a 1-compartment ODE whose elimination reads
  every DSL intrinsic the RHS generator took for the DSL (``floor``,
  ``ceil``, ``round``, ``sin``, ``cos``, ``tan``, ``log10``, ``log2``):
  kernel K2a with those device functions;
- :func:`covariates_ode_model`: ``examples/covariates.py:22-37`` as
  ``ode_model``: kernel K2e;
- :func:`readme_sde_model`: ``examples/sde_readme.py:22-37`` as
  ``sde_model``: kernel K3a.

Data for these models carries the routes' and outputs' names (``oral``,
``iv``, ``cp``); :func:`short_data` and :func:`creatinine_data` build it
from a numpy seed, with numeric labels for the closure models they are held
against.
"""

from __future__ import annotations

import numpy as np

SHORT_TIMES = (0.5, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 10.0, 12.0)

DSL_SHORT = """
name = short_1cmt_oral
kind = analytical
structure = one_compartment_with_absorption
params = v, ke, ka
states = depot, central
outputs = cp
bolus(oral) -> depot
out(cp) = central / v
"""

DSL_CREATININE = """
name = creatinine_1cmt_oral
kind = analytical
structure = one_compartment_with_absorption
params = ka, cl, v
covariates = wt@linear
derived = ke
states = depot, central
outputs = cp
bolus(oral) -> depot
ke = cl * pow(wt / 70.0, 0.75) / v
out(cp) = central / v
"""

DSL_ODE_SHORT = """
name = short_2cmt_oral_ode
kind = ode
params = ke, ka, kcp, kpc, v
states = depot, central, peripheral
outputs = cp
bolus(oral) -> depot
infusion(iv) -> central
dx(depot) = -ka * depot
dx(central) = ka * depot - (ke + kcp) * central + kpc * peripheral
dx(peripheral) = kcp * central - kpc * peripheral
out(cp) = central / v
"""

DSL_POPULATION = """
name = population_1cmt_oral
kind = analytical
structure = one_compartment_with_absorption
params = ka, ke, v
states = depot, central
outputs = cp
bolus(oral) -> depot
out(cp) = central / v
"""

DSL_INTRINSICS = """
name = intrinsics
kind = ode
params = ke, v, a
derived = k, f
states = central
outputs = cp
bolus(oral) -> central
f = 0.001 * floor(a) + 0.001 * ceil(a) + 0.001 * round(2.0 * a) + 0.001 * log10(v) + 0.001 * log2(v)
k = ke * (1.0 + 0.01 * sin(t) + 0.01 * cos(t) + 0.001 * tan(0.1 * t) + f)
dx(central) = -k * central
out(cp) = central / v
"""

# support centres, in each model's declared order
SHORT_CENTRE = (30.0, 0.2, 1.2)           # v, ke, ka
CREATININE_CENTRE = (1.2, 6.0, 30.0)      # ka, cl, v
ODE_SHORT_CENTRE = (0.15, 1.2, 0.3, 0.2, 10.0)
INTRINSICS_CENTRE = (0.2, 30.0, 1.3)


def covariates_ode_model(lib=None):
    """``examples/covariates.py:22-37``: the reference's covariate model as
    ``ode_model``, word for word."""
    if lib is None:
        import pharmsol_tpu_torch as lib
    return lib.ode_model(
        name="one_cmt_covariates",
        parameters=["ka", "ke", "tlag", "v"],
        covariates=["creatinine", "age"],
        states=["gut", "central"],
        outputs=["cp"],
        routes=[lib.Route.bolus("oral").to_state("gut")],
        dynamics=lambda s, p, t, cov: {
            "gut": -p.ka * s.gut,
            "central": p.ka * s.gut
            - p.ke * (cov.creatinine / 75.0) ** 0.75 * (cov.age / 25.0) ** 0.5 * s.central,
        },
        lag=lambda p, t, cov: {"oral": p.tlag},
        out=lambda s, p, t, cov: {"cp": s.central / p.v},
    )


def readme_sde_model(lib=None, nparticles: int = 1000):
    """``examples/sde_readme.py:22-37``: the README's SDE as ``sde_model``,
    word for word (``nparticles`` may be cut for the CPU)."""
    if lib is None:
        import pharmsol_tpu_torch as lib
    return lib.sde_model(
        name="ke_diffusion",
        parameters=["ke0", "v", "sigma_ke"],
        states=["central", "ke_latent"],
        outputs=["cp"],
        routes=[lib.Route.bolus("iv").to_state("central")],
        init=lambda p, t, cov: {"ke_latent": p.ke0},
        drift=lambda s, p, t, cov: {
            "central": -s.ke_latent * s.central,
            "ke_latent": -(s.ke_latent - p.ke0),  # mean-reverting
        },
        diffusion=lambda p, t, cov: {"ke_latent": p.sigma_ke},
        out=lambda s, p, t, cov: {"cp": s.central / p.v},
        nparticles=nparticles,
        seed=42,
    )


def short_data(n: int, seed: int, lib=None, named: bool = True, infusion: bool = False):
    """The reference's "Short" regimen: 100 mg oral at 0 and 9 observations
    over 12 h around 5 (``abs(5 + N(0, 1))``), with an infusion of 120 over
    2 h at 4 h into ``iv`` where asked. Labels ``oral``/``iv``/``cp`` when
    ``named``, else input and output 0."""
    if lib is None:
        import pharmsol_tpu_torch as lib
    oral, iv, cp = ("oral", "iv", "cp") if named else (0, 0, 0)
    rng = np.random.RandomState(seed)
    values = np.abs(5.0 + rng.randn(n, len(SHORT_TIMES)))
    subjects = []
    for i in range(n):
        b = lib.Subject.builder(f"s{i}").bolus(0.0, 100.0, oral)
        if infusion:
            b = b.infusion(4.0, 120.0, iv, 2.0)
        for t, v in zip(SHORT_TIMES, values[i]):
            b = b.observation(t, float(v), cp)
        subjects.append(b.build())
    return lib.Data(subjects)


def creatinine_data(n: int, seed: int, lib=None):
    """The Short regimen with a weight that changes over the day: knots at
    0 h (uniform 50-110 kg) and 24 h (0.8-1.2 times that), so the kernel
    inputs change within every occasion (K1b's segment mode)."""
    if lib is None:
        import pharmsol_tpu_torch as lib
    rng = np.random.RandomState(seed)
    wt0 = rng.uniform(50.0, 110.0, n)
    wt24 = wt0 * rng.uniform(0.8, 1.2, n)
    values = np.abs(5.0 + rng.randn(n, len(SHORT_TIMES)))
    subjects = []
    for i in range(n):
        b = (lib.Subject.builder(f"w{i}").bolus(0.0, 100.0, "oral")
             .covariate("wt", 0.0, float(wt0[i])).covariate("wt", 24.0, float(wt24[i])))
        for t, v in zip(SHORT_TIMES, values[i]):
            b = b.observation(t, float(v), "cp")
        subjects.append(b.build())
    return lib.Data(subjects)


def ems_for(lib=None, label="cp"):
    """Additive assay error (0.5 + 0.1 y, lambda 1) on ``label``."""
    if lib is None:
        import pharmsol_tpu_torch as lib
    return lib.AssayErrorModels().add(
        label, lib.AssayErrorModel.additive(lib.ErrorPoly(0.5, 0.1), 1.0))


def jittered(centre, S: int, seed: int, scale: float = 0.2) -> np.ndarray:
    """``S`` supports around ``centre``, each column scaled by ``1 + scale
    N(0, 1)`` (absolute value)."""
    rng = np.random.RandomState(seed)
    c = np.asarray(centre, dtype=np.float64)
    return np.abs(c[None, :] * (1.0 + scale * rng.randn(S, c.size)))
