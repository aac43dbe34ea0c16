"""K1a's anatomy on the card for the checkout at TREE: ptxas registers,
stack and spill of every K1a instantiation (and the K1b/K1c registers),
warps per SM, the kernel alone at the two K1a cells (Short 16384 x 512,
1-cmt 10000 x 1000) in both dtypes, issue slots per cell-segment, the bound,
and the clock64 share of each part of a cell, read from a probe copy of the
tree's ``csrc/fused_psi.cu`` that this script writes and builds in a
temporary directory (the probes are not in the shipped source). It knows
two layouts of the source: one thread a cell (``fused_psi_kernel``) and the
one tiered kernel body on the persistent grid.

    python3 chip_tools/k1a_probe.py TREE TAG
"""
import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

TREE, TAG = sys.argv[1], sys.argv[2]
sys.path.insert(0, str(Path(TREE).resolve()))
sys.path.insert(1, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import pharmsol_tpu_torch as pt  # noqa: E402
from pharmsol_tpu_torch.ops import _build  # noqa: E402
from pharmsol_tpu_torch.ops.fused_psi import _launch  # noqa: E402

assert Path(pt.__file__).resolve().parent.parent == Path(TREE).resolve()
card = cs.nvidia_smi()
print(f"[{TAG}] card {card}", flush=True)

# 64 slots of 8 counters (4 parts, threads in 7); a warp sums its lanes'
# counters and one lane adds them to its block's slot
HEAD = """
__device__ unsigned long long g_probe[512];
"""
TAIL = """
extern "C" int probe_read(unsigned long long* h) {
  return (int)cudaMemcpyFromSymbol(h, g_probe, sizeof(g_probe));
}
extern "C" int probe_reset() {
  static unsigned long long z[512];
  return (int)cudaMemcpyToSymbol(g_probe, z, sizeof(z));
}
"""
FLUSH = """  {
    const unsigned mask_ = __activemask();
    const int lane_ = (threadIdx.x + threadIdx.y * blockDim.x) & 31;
    const int slot_ = ((blockIdx.x + blockIdx.y) % 64) * 8;
    const bool first_ = lane_ == __ffs(mask_) - 1;
    for (int k_ = 0; k_ < 4; ++k_) {
      unsigned long long v_ = acc_[k_];
      for (int off_ = 16; off_ > 0; off_ >>= 1) {
        const unsigned long long o_ = __shfl_down_sync(mask_, v_, off_);
        if (lane_ + off_ < 32 && ((mask_ >> (lane_ + off_)) & 1u)) v_ += o_;
      }
      if (first_) atomicAdd(&g_probe[slot_ + k_], v_);
    }
    if (first_) atomicAdd(&g_probe[slot_ + 7], (unsigned long long)__popc(mask_));
  }
"""

# one thread a cell: fused_psi_kernel, a thread one row of one support
ONE_THREAD_A_CELL = [
    ("  T raw[NP];\n#pragma unroll\n  for (int j = 0; j < NP; ++j) raw[j] = params[(size_t)j * S + s];\n"
     "  Mdl mdl;\n  mdl.prepare(raw);\n",
     "  long long pc_ = clock64(); unsigned long long acc_[4] = {0, 0, 0, 0};\n"
     "  T raw[NP];\n#pragma unroll\n  for (int j = 0; j < NP; ++j) raw[j] = params[(size_t)j * S + s];\n"
     "  Mdl mdl;\n  mdl.prepare(raw);\n  acc_[0] += clock64() - pc_;\n"),
    ("(+ b_k)\n      if (obs_mask[i] > T(0)) {",
     "(+ b_k)\n      pc_ = clock64();\n      if (obs_mask[i] > T(0)) {"),
    ("                  : log_ndtr(sc * z);\n      }\n"
     "      // 2. the bolus (0 on padded slots) into the dose state\n"
     "      x[0] = x[0] + seg_bolus[i];\n",
     "                  : log_ndtr(sc * z);\n      }\n      acc_[1] += clock64() - pc_; pc_ = clock64();\n"
     "      x[0] = x[0] + seg_bolus[i];\n      acc_[2] += clock64() - pc_; pc_ = clock64();\n"),
    ("      if (dt > T(0)) mdl.propagate(x, dt, has_inf ? seg_rate[i] : T(0), has_inf);\n    }\n"
     "    out[(size_t)r * S + s] = ll;\n  }\n}\n",
     "      if (dt > T(0)) mdl.propagate(x, dt, has_inf ? seg_rate[i] : T(0), has_inf);\n"
     "      acc_[3] += clock64() - pc_;\n    }\n"
     "    out[(size_t)r * S + s] = ll;\n  }\n" + FLUSH + "}\n"),
]
# the tiered body: the base tier (TIER == 0) of fused_psi_feature_kernel (the
# probes sit in every tier's code; only K1a's launches are read): the
# support's prologue and each row's set-up, observation, bolus, propagate
# (the rest of the segment)
TIERED = [
    ("  Mdl mdl;\n  if (f.mode == MODE_NONE) {",
     "  long long pc_ = clock64(); unsigned long long acc_[4] = {0, 0, 0, 0};\n"
     "  Mdl mdl;\n  if (f.mode == MODE_NONE) {"),
    ("  const T fa_s = (fa != nullptr && f.fa_row == 0) ? fa[s] : T(1);\n",
     "  const T fa_s = (fa != nullptr && f.fa_row == 0) ? fa[s] : T(1);\n"
     "  acc_[0] += clock64() - pc_;\n"),
    ("  for (int r = blockIdx.y; r < R; r += gridDim.y) {\n    T x[NS];\n",
     "  for (int r = blockIdx.y; r < R; r += gridDim.y) {\n    pc_ = clock64();\n    T x[NS];\n"),
    ("    const size_t row = (size_t)r * M;\n    for (int m = 0; m < M; ++m) {\n"
     "      const size_t i = row + m;\n",
     "    const size_t row = (size_t)r * M;\n    acc_[0] += clock64() - pc_;\n"
     "    for (int m = 0; m < M; ++m) {\n      const size_t i = row + m;\n      pc_ = clock64();\n"),
    ("      const T bol = bolus_at();\n      if constexpr (!FEAT) {\n        x[0] = x[0] + bol;\n",
     "      acc_[1] += clock64() - pc_; pc_ = clock64();\n"
     "      const T bol = bolus_at();\n      if constexpr (!FEAT) {\n        x[0] = x[0] + bol;\n"
     "        acc_[2] += clock64() - pc_; pc_ = clock64();\n"),
    ("              pend_rem = pend_rem - dt > T(0) ? pend_rem - dt : T(0);\n            }\n"
     "          }\n        }\n      }\n    }\n    out[(size_t)r * S + s] = ll;\n  }\n}\n",
     "              pend_rem = pend_rem - dt > T(0) ? pend_rem - dt : T(0);\n            }\n"
     "          }\n        }\n      }\n      acc_[3] += clock64() - pc_;\n    }\n"
     "    out[(size_t)r * S + s] = ll;\n  }\n" + FLUSH + "}\n"),
]
EDITS = {"one thread a cell": ONE_THREAD_A_CELL, "tiered": TIERED}


def probe_source(src: str) -> str:
    for tag, edits in EDITS.items():
        if all(a in src for a, _ in edits):
            for a, b in edits:
                assert src.count(a) == 1, (tag, a[:60])
                src = src.replace(a, b)
            src = src.replace("#include <type_traits>\n", "#include <type_traits>\n" + HEAD, 1)
            return src + TAIL
    raise SystemExit("no probe anchors match this source")


def ptxas_table(out: str) -> dict:
    rows, name, spill = {}, None, ""
    for ln in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name, spill = m.group(1), ""
            continue
        if "spill stores" in ln:
            spill = ln.strip()
        elif "registers" in ln and name:
            key = cs.kernel_key(name)
            if key is not None and key.startswith("K1"):
                st = re.search(r"(\d+) bytes stack frame", spill)
                sp = re.search(r"(\d+) bytes spill stores", spill)
                rows[key] = dict(regs=int(re.search(r"Used (\d+) registers", ln).group(1)),
                                 stack=int(st.group(1)) if st else 0,
                                 spill=int(sp.group(1)) if sp else 0)
            name = None
    return rows


path, secs, out = _build.build(force=True, verbose=True)
lib = _build.bind_psi_library(ctypes.CDLL(str(path)))
table = ptxas_table(out)
# the base tier's occupancy query (tier 0), where the library has one
query = getattr(lib, "fused_psi_occupancy", None)
if query is not None:
    query.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
others = {k: (v["regs"], v["stack"], v["spill"]) for k, v in table.items() if not k.startswith("K1a")}
print(f"[{TAG}] K1b/K1c (registers, stack, spill): " + ", ".join(
    f"{k} {v}" for k, v in sorted(others.items())), flush=True)
table = {k: v for k, v in table.items() if k.startswith("K1a")}
for key in sorted(table, key=lambda k: (k.split()[1], int(k.split()[2]))):
    a = table[key]
    warps = None
    if query is not None:
        blocks = ctypes.c_int(0)
        if query(int(key.split()[1] == "f64"), int(key.split()[2]), 0,
                 ctypes.addressof(blocks)) == 0:
            warps = blocks.value * 4
    if warps is None:
        warps = cs.resident_blocks(a["regs"], 0, 256) * 8
    a["warps_per_sm"] = warps
    print(f"[{TAG}] {key}: {a['regs']} registers, {a['stack']} B stack, {a['spill']} B spill, "
          f"{warps} warps per SM", flush=True)

# the probe copy
pdir = Path(tempfile.mkdtemp(prefix="k1a_probe_"))
(pdir / "fused_psi_probe.cu").write_text(
    probe_source((Path(TREE) / "pharmsol_tpu_torch/csrc/fused_psi.cu").read_text()))
plib_path = pdir / "libfused_psi_probe.so"
subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(plib_path),
                str(pdir / "fused_psi_probe.cu")], check=True)
plib = _build.bind_psi_library(ctypes.CDLL(str(plib_path)))
plib.probe_read.argtypes = [ctypes.c_void_p]

rng = np.random.RandomState(cs.SEED)
short = cs.short_subjects(pt, 16384, rng)
m2 = pt.Analytical(pt.two_compartments_with_absorption,
                   out=lambda x, p, t, cov: x[1:2] / p[4], nstates=3, ndrugs=1, nout=1)
d10 = cs.short_subjects(pt, 10000, rng)
m1 = pt.Analytical(pt.one_compartment_with_absorption,
                   out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2, ndrugs=1, nout=1)
ems = pt.AssayErrorModels().add(0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
cells = [("Short 16384x512", m2, short, [0.15, 1.2, 0.3, 0.2, 10.0], 512),
         ("1-cmt 10000x1000", m1, d10, [1.2, 0.2, 30.0], 1000)]
record = dict(tag=TAG, card=card, ptxas=table, cells={})
for label, model, data, centre, S in cells:
    sp = cs.jittered_support(centre, S, np.random.RandomState(cs.SEED + 2), 0.2)
    for dtype in (torch.float32, torch.float64):
        pt.set_float_dtype(dtype)
        key = f"{label} {str(dtype)[6:]}"
        plan = cs.plan_for(pt, model, data, sp, ems, dtype)
        kw = plan.kernel_kwargs()
        runs = [cs.cuda_ms(lambda: cs.run_kernel(plan), 10) for _ in range(3)]
        ms = statistics.median(runs)
        segs = cs.cell_segments(plan)
        nbytes, ops = cs.psi_work(plan)
        bms, by = cs.bound(nbytes, ops, dtype)
        ref = cs.run_kernel(plan)
        buf = (ctypes.c_ulonglong * 512)()
        assert plib.probe_reset() == 0
        got, _ = _launch(plib, *plan.streams, plan.support, **kw)
        torch.cuda.synchronize()
        assert plib.probe_read(ctypes.addressof(buf)) == 0
        parts = [sum(buf[slot * 8 + k] for slot in range(64)) for k in range(4)]
        threads = sum(buf[slot * 8 + 7] for slot in range(64))
        total = sum(parts)
        shares = [p / total for p in parts]
        same = bool(torch.equal(got, ref))
        rec = dict(kernel_ms=ms, runs=runs, cell_segments=segs,
                   issue_slots=cs.issue_slots(ms, segs), bound_ms=bms, bound_by=by,
                   share_of_bound=bms / ms, clock_shares=shares, threads=threads,
                   cycles_per_cell_segment=total / segs, probe_psi_equal=same)
        record["cells"][key] = rec
        print(f"[{TAG}] {key}: kernel alone {ms:.4f} ms (runs {', '.join(f'{x:.4f}' for x in runs)}), "
              f"{segs} cell-segments, {rec['issue_slots']:.1f} issue slots per cell-segment, "
              f"bound {bms:.5f} ms by {by} (share {bms / ms:.3f}); clock64 shares prepare "
              f"{shares[0]:.3f} / observation {shares[1]:.3f} / bolus {shares[2]:.3f} / "
              f"propagate {shares[3]:.3f}, {total / segs:.1f} probed cycles per cell-segment, "
              f"probe psi equal {same} ({card})", flush=True)
        del plan, ref, got
print("PROBE " + json.dumps(record), flush=True)
