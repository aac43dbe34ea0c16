"""K1a alone at its two cells for several trees, each tree a process of its
own, in the order given and then reversed (A B B A): the median of three
runs of ten launches per side, each side's range, the factor of the medians
against the first tree, psi held cell by cell against the first tree.

    python3 chip_tools/k1a_time.py TREE_A TREE_B [...]
    python3 chip_tools/k1a_time.py --worker TREE OUT.npz   (one side)
"""
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def worker(tree: str, out: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    sys.path.insert(1, str(HERE))
    import numpy as np
    import torch

    import chip_smoke as cs
    import pharmsol_tpu_torch as pt
    from pharmsol_tpu_torch.ops import _build, fused_psi

    assert Path(pt.__file__).resolve().parent.parent == Path(tree).resolve()
    _build.load_library()
    rng = np.random.RandomState(cs.SEED)
    short = cs.short_subjects(pt, 16384, rng)
    m2 = pt.Analytical(pt.two_compartments_with_absorption,
                       out=lambda x, p, t, cov: x[1:2] / p[4], nstates=3, ndrugs=1, nout=1)
    d10 = cs.short_subjects(pt, 10000, rng)
    m1 = pt.Analytical(pt.one_compartment_with_absorption,
                       out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2, ndrugs=1, nout=1)
    ems = pt.AssayErrorModels().add(0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    ms, psi = {}, {}
    for label, model, data, centre, S in (
            ("Short 16384x512", m2, short, [0.15, 1.2, 0.3, 0.2, 10.0], 512),
            ("1-cmt 10000x1000", m1, d10, [1.2, 0.2, 30.0], 1000)):
        sp = cs.jittered_support(centre, S, np.random.RandomState(cs.SEED + 2), 0.2)
        for dtype in (torch.float32, torch.float64):
            pt.set_float_dtype(dtype)
            key = f"{label} {str(dtype)[6:]}"
            plan = cs.plan_for(pt, model, data, sp, ems, dtype)
            before = fused_psi.LAUNCHES
            out_ = cs.run_kernel(plan)
            torch.cuda.synchronize()
            assert fused_psi.LAUNCHES == before + 1
            psi[key] = out_.double().cpu().numpy()
            ms[key] = [cs.cuda_ms(lambda: cs.run_kernel(plan), 10) for _ in range(3)]
            del plan
    np.savez(out, **{k.replace(" ", "_"): v for k, v in psi.items()})
    print("TIME " + json.dumps(ms), flush=True)


def main() -> None:
    import numpy as np

    trees = sys.argv[1:]
    order = trees + trees[::-1]
    runs = {t: {} for t in trees}
    psis = {}
    with tempfile.TemporaryDirectory() as tmp:
        for k, tree in enumerate(order):
            out = str(Path(tmp) / f"side{k}.npz")
            proc = subprocess.run([sys.executable, __file__, "--worker", tree, out],
                                  capture_output=True, text=True, timeout=600)
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("TIME ")]
            if proc.returncode != 0 or not lines:
                raise SystemExit(f"{tree}: exit {proc.returncode}\n{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-3000:]}")
            for key, v in json.loads(lines[-1][5:]).items():
                runs[tree].setdefault(key, []).extend(v)
            with np.load(out) as z:
                psis.setdefault(tree, {k_: z[k_] for k_ in z.files})
            print(f"[time] side {k} {tree} done", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    base = trees[0]
    for key in runs[base]:
        b = runs[base][key]
        for tree in trees:
            r = runs[tree][key]
            f = statistics.median(b) / statistics.median(r)
            apart = ("faster beyond the spread" if max(r) < min(b) else
                     "slower beyond the spread" if min(r) > max(b) else "within the spread")
            print(f"[time] {key} {tree}: median {statistics.median(r):.4f} ms "
                  f"({min(r):.4f}-{max(r):.4f}), factor {f:.3f} against {base} ({apart}) ({card})",
                  flush=True)
    for tree in trees[1:]:
        for key, want in psis[base].items():
            got = psis[tree][key]
            cell = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
            print(f"[time] psi {key} {tree} vs {base}: {int((got != want).sum())} of {got.size} "
                  f"cells differ, max rel {cell.max():.3e}, {(cell <= 1e-5).mean():.6f} within "
                  f"1e-5", flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "--worker":
        worker(sys.argv[2], sys.argv[3])
    else:
        main()
