"""The general engine's psi on the CPU, float64, for several trees, held cell
by cell against the first tree: every case of ``utils/f32_budget.py``'s
feature, K1c, ODE-feature and SDE-feature tables, three closed forms, an
expm and a bdf case (the SDE cases with noise: the draws must match too).
Each tree runs in a process of its own that imports its own package.

    python3 chip_tools/psi_trees.py TREE_A TREE_B [...]
    python3 chip_tools/psi_trees.py --worker TREE OUT.npz   (one side)

Prints, per tree after the first, the cases that differ at all and the
largest relative difference; exits 1 if any cell differs.
"""
import subprocess
import sys
import tempfile
from pathlib import Path


def worker(tree: str, out: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch

    import pharmsol_tpu_torch as pt
    from pharmsol_tpu_torch.utils import f32_budget as fb

    assert Path(pt.__file__).resolve().is_relative_to(Path(tree).resolve()), pt.__file__
    torch.set_num_threads(2)
    pt.set_device("cpu")
    res = {}

    def go(key, case):
        m, d, sp, ems = case[:4]
        res[key] = pt.log_likelihood_matrix(m, d, sp, ems, engine="general").numpy()

    for name in fb.FEATURE_CASES:
        go("feature_" + name, fb.feature_case(name, 3, 4))
    for name in fb.K1C_CASES:
        go("k1c_" + name, fb.k1c_case(name, 3, 4))
    for name in fb.ODE_FEATURE_CASES:
        go("ode_" + name, fb.ode_feature_case(name, 2, 3))
    for name in fb.SDE_FEATURE_CASES:
        go("sde_" + name, fb.sde_feature_case(name, 2, 3))
    for name in ("one_compartment", "two_compartments_with_absorption", "three_compartments_cl"):
        go("closed_" + name, fb.kernel_case(name))
    go("expm_" + next(iter(fb.EXPM_CASES)), fb.expm_case(next(iter(fb.EXPM_CASES)), 2, 3))
    go("bdf_tmdd", fb.stiff_case("tmdd", 2, 3, solver="bdf"))
    np.savez(out, **res)


def main(trees) -> int:
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        outs = []
        for i, tree in enumerate(trees):
            out = str(Path(tmp) / f"psi{i}.npz")
            subprocess.run([sys.executable, __file__, "--worker", tree, out], check=True)
            outs.append(np.load(out))
        base = outs[0]
        bad = 0
        for tree, other in zip(trees[1:], outs[1:]):
            differ = [k for k in base if not np.array_equal(base[k], other[k], equal_nan=True)]
            worst = max((float(np.nanmax(np.abs(other[k] - base[k])
                                         / np.maximum(np.abs(base[k]), 1e-300)))
                         for k in differ), default=0.0)
            print(f"{tree}: {len(base)} cases, {len(differ)} differ {differ}, "
                  f"largest relative difference {worst:.3e}")
            bad += len(differ)
    return 1 if bad else 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        worker(sys.argv[2], sys.argv[3])
    else:
        sys.exit(main(sys.argv[1:]))
