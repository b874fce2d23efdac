"""A/B of design choices in B4's float32 kernel, on a CUDA card.

    python3 tools/ab_conv4d_tf32.py

Builds ``patch2pix_tpu_torch/csrc/conv4d.cu`` as it is (``shipped``) and
variants of its float32 kernel (``conv4d_small_tf32_kernel``), each from
a text transform of that source, one ``nvcc`` each, all started together
into ``build/ab_conv4d_tf32/``:

- ``tc_accumulate``: the tensor cores accumulate all nine outer taps (no
  per-tap float32 sums);
- ``cvt_rna``: the A split rounds with ``cvt.rna.tf32.f32``;
- ``unrolled_di``: the di loop unrolled, as u3 is;
- ``ldmatrix``: Cin 4's A fragments by one ``ldmatrix.x4`` each;
- ``no_branch``: every cell's MMAs run, valid or not, and both column
  groups' (the validity test kept where a tap's sum is added);
- ``passes``: the three products in three passes over the six
  accumulators;
- ``one_product``: hi*hi' alone, a diagnostic of the MMAs' share (it
  misses the 1e-4 rule).

Prints each build's seconds (all compiling at once), ptxas's registers
and spills and the SASS instruction mix (``cuobjdump``) of the <float, 4,
4, 1> instance, then, in turns (each variant, then in reverse), the
wrapper's ms by CUDA events and device ms (profiler) on the
change_stride NCN volume (2, 48, 64, 48, 64, 4) 4->4 channels-last, and
the max abs error to the plain version there and on a ragged shape.
Imports no JAX.
"""

from __future__ import annotations

import collections
import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from patch2pix_tpu_torch.ops import _build  # noqa: E402
from patch2pix_tpu_torch.ops.conv4d_small import (  # noqa: E402
    _SIGNATURES,
    conv4d_small,
    conv4d_small_plain,
)

OUT = Path(__file__).resolve().parents[1] / "build" / "ab_conv4d_tf32"
INSTANCE = "tf32_kernelIfLi4ELi4ELi1E"  # <float, 4, 4, staging 1>

A_LOADS = """          uint32_t hi[2][4], lo[2][4];
#pragma unroll
          for (int lg = 0; lg < 2; ++lg)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int m8 = 0; m8 < 2; ++m8) {  // A rows g, g+8: 8 positions on in l
                const int o = aoff[ks][h];
                const float v = o >= 0 ? xa[16 * lg * CIN + o + 8 * CIN * m8] : 0.0f;
                const uint32_t vh = tf32_round(v);
                hi[lg][2 * h + m8] = vh;
                lo[lg][2 * h + m8] = __float_as_uint(__fsub_rn(v, __uint_as_float(vh)));
              }
"""
A_LDMATRIX = """          uint32_t hi[2][4], lo[2][4];
#pragma unroll
          for (int lg = 0; lg < 2; ++lg) {
            uint32_t a[4];
            if (T_IN_BASE) {  // lane i: matrix 2h + m8 = i / 8, A row i % 8 + 8*m8
              const int ld_h = lane >> 4, ld_row = (lane & 7) + 8 * ((lane >> 3) & 1);
              const uint32_t addr = xs_u32 + 4u * (uint32_t)((xa - xs) - g * CIN - t +
                  ld_row * CIN + (ld_h ? aoff[ks][1] : aoff[ks][0]) + 16 * lg * CIN);
              asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                           : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
            } else {
#pragma unroll
              for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int m8 = 0; m8 < 2; ++m8) {
                  const int o = aoff[ks][h];
                  a[2 * h + m8] =
                      o >= 0 ? __float_as_uint(xa[16 * lg * CIN + o + 8 * CIN * m8]) : 0u;
                }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float v = __uint_as_float(a[e]);
              hi[lg][e] = tf32_round(v);
              lo[lg][e] = __float_as_uint(__fsub_rn(v, __uint_as_float(hi[lg][e])));
            }
          }
"""
MMAS = """#pragma unroll
          for (int dj = 0; dj < 3; ++dj) {
            // the strip's cell j0 + c - dj reads this plane through tap (di, dj)
            if (c - dj < 0 || c - dj >= J || j0 + c - dj >= jend) continue;
#pragma unroll
            for (int nt = 0; nt < NTL; ++nt) {
              const uint4 b = bs[(((di * 3 + dj) * KS + ks) * NTL + nt) * 32 + lane];
#pragma unroll
              for (int lg = 0; lg < 2; ++lg) {
                if (lg == 1 && !right) continue;
                // the small products first
                mma_tf32(part[dj][lg][nt], lo[lg], b.x, b.y);
                mma_tf32(part[dj][lg][nt], hi[lg], b.z, b.w);
                mma_tf32(part[dj][lg][nt], hi[lg], b.x, b.y);
              }
            }
          }
"""
MMAS_PASSES = """          uint4 bb[3][NTL];
#pragma unroll
          for (int dj = 0; dj < 3; ++dj)
#pragma unroll
            for (int nt = 0; nt < NTL; ++nt)
              bb[dj][nt] = bs[(((di * 3 + dj) * KS + ks) * NTL + nt) * 32 + lane];
#pragma unroll
          for (int pp = 0; pp < 3; ++pp)
#pragma unroll
            for (int dj = 0; dj < 3; ++dj) {
              if (c - dj < 0 || c - dj >= J || j0 + c - dj >= jend) continue;
#pragma unroll
              for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
                for (int lg = 0; lg < 2; ++lg) {
                  if (lg == 1 && !right) continue;
                  const uint4 b = bb[dj][nt];
                  if (pp == 0) mma_tf32(part[dj][lg][nt], lo[lg], b.x, b.y);
                  if (pp == 1) mma_tf32(part[dj][lg][nt], hi[lg], b.z, b.w);
                  if (pp == 2) mma_tf32(part[dj][lg][nt], hi[lg], b.x, b.y);
                }
            }
"""
DI_LOOP = "      // not unrolled (see the header)\n#pragma unroll 1\n"

# name -> [(text in the float32 kernel, its replacement, occurrences)]
VARIANTS = {
    "shipped": [],
    "tc_accumulate": [
        ("mma_tf32(part[dj][lg][nt], ", "mma_tf32(acc[(u3 - dj + 3) % 3][lg][nt], ", 3),
        ("for (int e = 0; e < 4; ++e) part[dj][lg][nt][e] = 0.0f;", ";", 1),
        ("c4[lg][nt][e] = __fadd_rn(c4[lg][nt][e], part[dj][lg][nt][e]);", "(void)c4;", 1)],
    "cvt_rna": [("const uint32_t vh = tf32_round(v);",
                 "uint32_t vh;\n                asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(vh) : \"f\"(v));",
                 1)],
    "unrolled_di": [(DI_LOOP, "#pragma unroll\n", 1)],
    "ldmatrix": [(A_LOADS, A_LDMATRIX, 1)],
    "no_branch": [
        ("            // the strip's cell j0 + c - dj reads this plane through tap (di, dj)\n"
         "            if (c - dj < 0 || c - dj >= J || j0 + c - dj >= jend) continue;\n", "", 1),
        ("                if (lg == 1 && !right) continue;\n", "", 1)],
    "passes": [(MMAS, MMAS_PASSES, 1)],
    "one_product": [("mma_tf32(part[dj][lg][nt], lo[lg], b.x, b.y);", "", 1),
                    ("mma_tf32(part[dj][lg][nt], hi[lg], b.z, b.w);", "", 1)],
}


def variant_source(src, edits):
    """The source with ``edits`` applied to the float32 kernel only."""
    at = src.index("conv4d_small_tf32_kernel(const float")
    head, body = src[:at], src[at:]
    for old, new, count in edits:
        if body.count(old) != count:
            raise ValueError(f"{old[:60]!r} occurs {body.count(old)} times, not {count}")
        body = body.replace(old, new)
    return head + body


def build_all():
    """Compile every variant at once; {name: (seconds, ptxas report)}."""
    src = (_build.CSRC / "conv4d.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        cu = OUT / f"conv4d_{name}.cu"
        cu.write_text(variant_source(src, edits))
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(OUT / f"lib_{name}.so"), str(cu)]
        procs[name] = (time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    secs = {}
    while len(secs) < len(procs):
        for name, (t0, proc) in procs.items():
            if name not in secs and proc.poll() is not None:
                secs[name] = time.perf_counter() - t0
        time.sleep(0.1)
    reports = {}
    for name, (_, proc) in procs.items():
        report = proc.stdout.read()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        reports[name] = (secs[name], report)
    return reports


def describe(name, secs, report):
    lines = report.splitlines()
    regs = ""
    for i, line in enumerate(lines):
        if "Compiling entry" in line and INSTANCE in line:
            regs = "; ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                             if "registers" in x or "spill" in x)
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(OUT / f"lib_{name}.so")],
                          capture_output=True, text=True).stdout
    m = re.search(r"Function : \S*" + INSTANCE + r"\S*(.*?)(?=\n\s*Function :|\Z)", sass, re.S)
    mix = "SASS not read"
    if m:
        ops = collections.Counter(re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", m.group(1)))
        mix = f"SASS {sum(ops.values())}: " + ", ".join(f"{k} {v}" for k, v in ops.most_common(12))
    print(f"{name}: nvcc {secs:.1f} s; {regs}; {mix}", flush=True)


def load(name):
    lib = ctypes.CDLL(str(OUT / f"lib_{name}.so"))
    for fn, codes in _SIGNATURES.items():
        f = getattr(lib, fn)
        f.argtypes = [_build._CTYPES[c] for c in codes]
        f.restype = ctypes.c_int
    return lib


def time_ms(fn, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.time_range.elapsed_us() / 1e3 for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA and "tf32_kernel" in ev.name)


def main():
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    reports = build_all()
    for name, (secs, report) in reports.items():
        describe(name, secs, report)
    libs = {name: load(name) for name in VARIANTS}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x = torch.randn((2, 48, 64, 48, 64, 4), generator=gen, device=dev)
    w = torch.randn((3, 3, 3, 3, 4, 4), generator=gen, device=dev) / 18
    b = torch.randn((4,), generator=gen, device=dev) * 0.1
    ragged = torch.randn((1, 3, 5, 11, 37, 4), generator=gen, device=dev)
    want, want_r = conv4d_small_plain(x, w, b), conv4d_small_plain(ragged, w, b)
    saved = _build._loaded.get("conv4d")
    try:
        names = list(VARIANTS)
        for name in names + names[::-1]:
            _build._loaded["conv4d"] = libs[name]
            err = (conv4d_small(x, w, b) - want).abs().max().item()
            err_r = (conv4d_small(ragged, w, b) - want_r).abs().max().item()
            ms = time_ms(lambda: conv4d_small(x, w, b))
            dms = device_ms(lambda: conv4d_small(x, w, b))
            print(f"{name}: {ms:.4f} ms by events, {dms:.4f} device ms, max abs err {err:.3g} "
                  f"(ragged {err_r:.3g})", flush=True)
    finally:
        if saved is None:
            _build._loaded.pop("conv4d", None)
        else:
            _build._loaded["conv4d"] = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
