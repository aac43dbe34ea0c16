"""Fit A (chip_smoke.py phase 10: the closed-form 1-cmt oral NPAG fit,
10 000 subjects, float64, every psi call one K1a launch) for several trees,
each a process of its own, in the order given and then reversed; each side
fits twice and reports the second fit (seconds, psi stage, launches).

    python3 chip_tools/fit_pair.py TREE_A TREE_B
"""
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

if sys.argv[1] == "--worker":
    sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
    sys.path.insert(1, str(HERE))
    import chip_smoke as cs
    import pharmsol_tpu_torch as pt
    from pharmsol_tpu_torch.utils.f32_budget import population_10k_case, population_models

    assert Path(pt.__file__).resolve().parent.parent == Path(sys.argv[2]).resolve()
    data, ems, _ = population_10k_case(cs.FIT_SUBJECTS)
    closed, _ = population_models()
    card = cs.nvidia_smi()
    out = []
    for k in range(2):
        r = cs.phase_fit(pt, f"fit A {sys.argv[2]} #{k}", closed, data, ems, "K1a", card)
        out.append(dict(seconds=r["seconds"], psi_s=r["psi_s"], psi_calls=r["psi_calls"],
                        launches=r["launches"], weights_s=r["weights_s"],
                        log_likelihood=float(r["fit"].log_likelihood)))
    print("FIT " + json.dumps(out), flush=True)
else:
    trees = sys.argv[1:]
    for tree in trees + trees[::-1]:
        proc = subprocess.run([sys.executable, __file__, "--worker", tree], capture_output=True,
                              text=True, timeout=600)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("FIT ")]
        if proc.returncode != 0 or not lines:
            raise SystemExit(f"{tree}: {proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
        for ln in proc.stdout.splitlines():
            if ln.startswith("[10]") and "#1" in ln:
                print(tree, ln, flush=True)
        print(f"[fit] {tree}: " + json.dumps(json.loads(lines[-1][4:])[1]), flush=True)
