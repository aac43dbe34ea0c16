"""K1a's register caps: builds the closed-form library of the checkout at
TREE once per cap variant (``TierBlocks``' K1a line replaced by each
variant's expressions, in a temporary directory), all at once, prints each
variant's K1a registers, stack, spill and warps per SM, then times K1a alone
at the two K1a cells in both dtypes, the variants in turn three times (CUDA
events, ten launches a run), and checks that every variant gives the first
one's psi bit for bit.

    python3 chip_tools/k1a_caps.py TREE
"""
import ctypes
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

TREE = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(TREE))
sys.path.insert(1, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import pharmsol_tpu_torch as pt  # noqa: E402
from pharmsol_tpu_torch.ops import _build  # noqa: E402
from pharmsol_tpu_torch.ops.fused_psi import _launch  # noqa: E402

LINE = "      TIER == TIER_K1A ? (F32 ? 1 : (NCMT == 3 ? 2 : CODE == 7 ? 4 : 5))"
# name: (K1a float32 blocks, K1a float64 blocks), C++ expressions of NCMT, CODE
VARIANTS = {
    "cap64": ("(NCMT == 3 ? 4 : 8)", "(NCMT == 3 ? 2 : CODE == 7 ? 4 : 5)"),
    "f1c16": ("(NCMT == 3 ? 4 : NCMT == 1 ? 16 : 8)", "(NCMT == 3 ? 2 : CODE == 7 ? 4 : 5)"),
    "f1c12": ("(NCMT == 3 ? 4 : NCMT == 1 ? 12 : 8)", "(NCMT == 3 ? 2 : CODE == 7 ? 4 : 5)"),
    "f2c10": ("(NCMT == 3 ? 4 : NCMT == 1 ? 8 : 10)", "(NCMT == 3 ? 2 : CODE == 7 ? 4 : 5)"),
    "ffree": ("1", "(NCMT == 3 ? 2 : CODE == 7 ? 4 : 5)"),
}
card = cs.nvidia_smi()
src = (TREE / "pharmsol_tpu_torch/csrc/fused_psi.cu").read_text()
assert src.count(LINE) == 1
root = Path(tempfile.mkdtemp(prefix="k1a_caps_"))
procs = {}
for name, (e32, e64) in VARIANTS.items():
    (root / f"{name}.cu").write_text(src.replace(LINE, f"      TIER == TIER_K1A ? (F32 ? {e32} : {e64})"))
    procs[name] = subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(root / f"{name}.so"),
         str(root / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
libs = {}
for name, proc in procs.items():
    out, _ = proc.communicate()
    assert proc.returncode == 0, out[-3000:]
    libs[name] = _build.bind_psi_library(ctypes.CDLL(str(root / f"{name}.so")))
    kname, spill, rows = None, "", []
    for ln in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            kname, spill = m.group(1), ""
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "registers" in ln and kname:
            key = cs.kernel_key(kname)
            if key is not None and key.startswith("K1a"):
                regs = re.search(r"Used (\d+) registers", ln).group(1)
                st = re.search(r"(\d+) bytes stack frame", spill)
                sp = re.search(r"(\d+) bytes spill stores", spill)
                rows.append(f"{key.split(' ', 1)[1]}: {regs}"
                            + (f"/st{st.group(1)}" if st and st.group(1) != "0" else "")
                            + (f"/SPILL{sp.group(1)}" if sp and sp.group(1) != "0" else ""))
            kname = None
    occ = []
    lib = libs[name]
    for f64 in (0, 1):
        for code in (1, 3, 5, 7, 9):
            blocks = ctypes.c_int(0)
            lib.fused_psi_occupancy(f64, code, 0, ctypes.addressof(blocks))
            occ.append(f"{'f64' if f64 else 'f32'} {code}: {blocks.value * 4} warps")
    print(f"[sweep] {name} {VARIANTS[name]}: " + ", ".join(sorted(rows)) + "; " + ", ".join(occ),
          flush=True)

rng = np.random.RandomState(cs.SEED)
short = cs.short_subjects(pt, 16384, rng)
m2 = pt.Analytical(pt.two_compartments_with_absorption,
                   out=lambda x, p, t, cov: x[1:2] / p[4], nstates=3, ndrugs=1, nout=1)
d10 = cs.short_subjects(pt, 10000, rng)
m1 = pt.Analytical(pt.one_compartment_with_absorption,
                   out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2, ndrugs=1, nout=1)
ems = pt.AssayErrorModels().add(0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
for label, model, data, centre, S in (("Short 16384x512", m2, short, [0.15, 1.2, 0.3, 0.2, 10.0], 512),
                                      ("1-cmt 10000x1000", m1, d10, [1.2, 0.2, 30.0], 1000)):
    sp = cs.jittered_support(centre, S, np.random.RandomState(cs.SEED + 2), 0.2)
    for dtype in (torch.float32, torch.float64):
        pt.set_float_dtype(dtype)
        plan = cs.plan_for(pt, model, data, sp, ems, dtype)
        kw = plan.kernel_kwargs()
        runs = {name: [] for name in libs}
        first = None
        for name, lib in libs.items():
            got, kernel = _launch(lib, *plan.streams, plan.support, **kw)
            assert kernel == "K1a"
            torch.cuda.synchronize()
            if first is None:
                first = got
            elif not torch.equal(got, first):
                raise AssertionError(f"{label} {dtype} {name}: psi differs from the first variant")
        for _ in range(3):
            for name, lib in libs.items():
                runs[name].append(cs.cuda_ms(
                    lambda: _launch(lib, *plan.streams, plan.support, **kw), 10))
        segs = cs.cell_segments(plan)
        for name, r in runs.items():
            ms = statistics.median(r)
            print(f"[sweep] {label} {str(dtype)[6:]} {name}: kernel alone {ms:.4f} ms "
                  f"({min(r):.4f}-{max(r):.4f}), {cs.issue_slots(ms, segs):.1f} issue slots per "
                  f"cell-segment ({card})", flush=True)
        del plan, first
