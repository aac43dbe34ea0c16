"""Objective evaluations per L-BFGS step of a replicate refit, on the CPU.

Fits the Laplace model of ``chip_smoke.py`` phase 24 (its 200-subject
population, float64) and then runs the first lanes of phase 25's bootstrap
refit (``--program boot``: the case-bootstrap weights of
``bootstrap_laplace(seed=0)``) or of its likelihood profile (``--program
llp``: lanes pinned at the nearest or the farthest grid point of each
parameter and side) from the fit's optimum, printing for every step the
evaluations it took (the line search's rounds, the most over the lanes) and
the largest gradient entry after it. A lane that has converged spends each
later step in a line search at the objective's noise floor.

    python3 chip_tools/refit_trace.py --program boot --lanes 8 --steps 20
    python3 chip_tools/refit_trace.py --program llp --rank far --steps 12
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--program", choices=["boot", "llp"], default="boot")
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--rank", choices=["near", "far"], default="far")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)

    import chip_smoke as cs
    import pharmsol_tpu_torch as pt
    from pharmsol_tpu_torch.optimize._lbfgs import BatchLbfgs, batch_value_and_grad_fn
    from pharmsol_tpu_torch.optimize.laplace import laplace_hessian

    pt.set_float_dtype(torch.float64)
    closed, _, rems = cs.est_models(pt)
    pop = cs.est_laplace_population(pt, cs.EST_POP)
    intro = {}
    t0 = time.perf_counter()
    pt.optimize.fit_laplace(closed, pop, rems, list(cs.EST_THETA0), _introspect=intro,
                            compute_se=False, device="cpu")
    z_opt = torch.as_tensor(intro["z_opt"])
    n = cs.EST_POP
    neg_w = intro["neg_laplace_w_lanes"]
    if args.program == "boot":
        draws = np.random.default_rng(0).integers(0, n, size=(cs.DIAG_N_BOOT, n))
        W = torch.tensor(np.stack([np.bincount(r, minlength=n) for r in draws])[:args.lanes],
                         dtype=torch.float64)

        def obj(Z):
            return neg_w(Z, W)
    else:
        # llp's grid: 12 points a side over 4 Wald SDs of each typical value
        sd = np.sqrt(np.diag(np.linalg.inv(laplace_hessian(intro["neg_laplace"], z_opt))))
        off = 4.0 if args.rank == "far" else 4.0 / 12
        rows = [(j, s) for j in range(int(intro["layout"]["p"])) for s in (-1.0, 1.0)]
        M = torch.zeros((len(rows), z_opt.numel()), dtype=torch.float64)
        V = torch.zeros(len(rows), dtype=torch.float64)
        for i, (j, s) in enumerate(rows):
            M[i, j] = 1.0
            V[i] = float(z_opt[j]) + s * off * sd[j]
        ones = torch.ones((len(rows), n), dtype=torch.float64)

        def obj(Z):
            return neg_w(torch.where(M > 0, V[:, None], Z), ones)

    count = [0]
    base = batch_value_and_grad_fn(obj)

    def vg(z):
        count[0] += 1
        return base(z)

    B = W.shape[0] if args.program == "boot" else M.shape[0]
    z = z_opt.expand(B, -1).clone()
    opt = BatchLbfgs()
    state = opt.init(z)
    print(f"fit {time.perf_counter() - t0:.1f} s; {args.program}, {B} lanes")
    for step in range(args.steps):
        before = count[0]
        value, grad = opt.value_and_grad_from_state(vg, z, state)
        z, state = opt.step(vg, z, state, value, grad)
        print(f"step {step + 1}: {count[0] - before} evaluations, largest gradient entry "
              f"{float(state.grad.abs().max()):.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
