"""Where a step of the GRU layer kernel (``csrc/native_runner.cu``
``gru_layer_kernel``) spends its time, on one NVIDIA GPU (Hopper, sm_90a).

    python3 tools/torch_gru_layer_phases.py [--frames 31]

from the root of a checkout.  It copies the kernel's source out of the
runner, adds clock64() counters around each phase of a step (the wait for
a ring stage, the k loop, the grid barrier, the cell, the L2 prefetch of
x·W_i, the exchange between a cluster's two blocks) and switches that
leave a phase out, builds that copy alone with nvcc into
``build/gru_phases/`` and runs it at GruModel's width (B=256, H=1024, the
resident-W_h instantiation) for each switch.  A switched-off phase gives
wrong outputs: the copy only times.  It prints one JSON line a variant:
the ms a step by CUDA events and each phase's mean SM clocks a step over
the blocks; the variants also leave out the h or the W_h loads of the k
loop (an operand from registers), to show what the shared-memory loads
cost.  The first line names the card and its power limit.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from learnablepoolingmethods_torch.core import native_runtime  # noqa: E402
from learnablepoolingmethods_torch.ops import kernel_build  # noqa: E402

OUT = ROOT / "build" / "gru_phases"
PHASES = ("wait", "k_loop", "grid_sync", "cell", "prefetch", "exchange")
# switch → what it leaves out
SWITCHES = {0: "nothing", 1: "grid barrier", 2: "k loop's FMA and loads", 4: "ring copies",
            6: "ring copies and FMA", 8: "cell"}
H_LOAD = "const float4 h4 = *reinterpret_cast<const float4*>(hs + (rg + kGruRowGroups * i) * kGruChunk + 4 * q);"
W_LOAD = ("w[c] = *reinterpret_cast<const float4*>(ws + ((c >> 1) * kGruUnits + v + 16 * (c & 1)) * w_pitch "
          "+ 4 * q);")


def instrumented(no_h: bool, no_w: bool) -> str:
    """The kernel with its phase counters and switches, as a standalone
    source with a C launcher ``gru_phases``."""
    src = kernel_build.sources(native_runtime.LIBRARY)[0].read_text()
    consts = src[src.index("constexpr int kGruThreads"):src.index("// the counted launches")]
    begin = src.index("template <bool kResident>\n__global__ void __launch_bounds__(kGruThreads, 1)\ngru_layer_kernel")
    kern = src[begin:src.index("// pool_attention's block: the scaled queries")]
    edits = [
        ("const int32_t* __restrict__ nf, int B, int F, int H, int Hp, int Kh) {",
         "const int32_t* __restrict__ nf, int B, int F, int H, int Hp, int Kh, int off, long long* prof) {\n"
         "  long long c[6] = {0, 0, 0, 0, 0, 0}, ts = 0;\n"),
        ("if (t + 1 < F) grid.sync();", "TIC if (t + 1 < F && !(off & 1)) grid.sync(); TOC(2)"),
        ("          lpm::cp_async_wait<kGruStages - 2>();  // stage m has landed\n          __syncthreads();",
         "          if (m) { TOC(1) } TIC lpm::cp_async_wait<kGruStages - 2>();\n          __syncthreads(); TOC(0) TIC"),
        ("          const float* hs = ring + (m % kGruStages) * kStageFloats;\n",
         "          if (off & 2) continue;\n          const float* hs = ring + (m % kGruStages) * kStageFloats;\n"),
        ("        load_cells();\n        // the two halves' sums", "        TOC(1) TIC\n        load_cells();\n        // the two halves' sums"),
        ("        __syncthreads();  // the ring is free for the next tile's stages\n",
         "        __syncthreads();  // the ring is free for the next tile's stages\n        TOC(5)\n"),
        ("        auto load_stage = [&](int m, int s) {\n", "        auto load_stage = [&](int m, int s) {\n          if (off & 4) return;\n"),
        ("      // the cells' x·W_i, from HBM into L2", "      TIC\n      // the cells' x·W_i, from HBM into L2"),
        ("      // acc[i][2g + s]", "      TOC(4)\n      // acc[i][2g + s]"),
        ("#pragma unroll\n      for (int i = 0; i < kGruRowsPerThread; ++i) {\n        const long long b = row0 + rg + kGruRowGroups * i;\n"
         "        if (b >= B) continue;",
         "      TIC\n#pragma unroll\n      for (int i = 0; i < kGruRowsPerThread; ++i) {\n"
         "        const long long b = row0 + rg + kGruRowGroups * i;\n        if (b >= B || (off & 8)) continue;"),
        ("    TIC if (t + 1 < F", "    TOC(3)\n    TIC if (t + 1 < F"),
        (H_LOAD, H_LOAD.replace("= *", "= %s ? make_float4(1.f, 0.5f, 0.25f, 2.f) : *" % str(no_h).lower())),
        (W_LOAD, W_LOAD.replace("= *", "= %s ? make_float4(1.f, 0.5f, 0.25f, 2.f) : *" % str(no_w).lower())),
    ]
    for old, new in edits:
        if kern.count(old) != 1:
            raise AssertionError(f"gru_layer_kernel no longer holds, once: {old[:60]}")
        kern = kern.replace(old, new)
    end = kern.rindex("}\n")
    kern = (kern[:end] + "  if (threadIdx.x == 0 && prof)\n    for (int p = 0; p < 6; ++p) prof[blockIdx.x * 6 + p] = c[p];\n"
            + kern[end:])
    return """#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include "tensor_core.cuh"
#define TIC ts = clock64();
#define TOC(p) c[p] += clock64() - ts;
namespace cg = cooperative_groups;
namespace phases {
__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ int last_frame(int nf, int F) {
  const int n = (min(nf, F) - 1) % F;
  return n < 0 ? n + F : n;
}
""" + consts + kern + """}  // namespace phases

extern "C" int gru_phases(const float* pre, const float* w_h, const float* b_i, const float* b_hn, float* hbuf,
                          float* seq, float* carry, const int* nf, int B, int F, int H, int off, long long* prof,
                          void* stream) {
  using namespace phases;
  long long ld_pre_b = (long long)F * 3 * H, ld_pre_t = 3 * H, ld_seq_b = (long long)F * H, ld_seq_t = H;
  int Hp = (H + 3) / 4 * 4, Kh = ((H + 1) / 2 + kGruChunk - 1) / kGruChunk * kGruChunk;
  size_t smem = 4 * ((size_t)kGruCols * (Kh + 4) + (size_t)kGruStages * kGruStageH);
  cudaFuncSetAttribute((const void*)gru_layer_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  unsigned tiles = (unsigned)(((B + kGruRows - 1) / kGruRows) * ((H + kGruUnits - 1) / kGruUnits));
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 2;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * tiles);
  cfg.blockDim = dim3(kGruThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  return (int)cudaLaunchKernelEx(&cfg, gru_layer_kernel<true>, pre, ld_pre_b, ld_pre_t, w_h, b_i, b_hn, hbuf, seq,
                                 ld_seq_b, ld_seq_t, carry, nf, B, F, H, Hp, Kh, off, prof);
}
"""


def build(name: str, source: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    cu, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(source)
    subprocess.run([kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-I", str(kernel_build.CSRC_DIR), "-o", str(lib),
                    str(cu)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--frames", type=int, default=31)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the kernel runs on the card only")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    b, h, f = 256, 1024, args.frames
    gen = torch.Generator(device=dev).manual_seed(1)
    pre = torch.randn((b, f, 3 * h), generator=gen, device=dev)
    w_h = torch.randn((h, 3 * h), generator=gen, device=dev) / 32
    b_i, b_hn = torch.zeros(3 * h, device=dev), torch.zeros(h, device=dev)
    hbuf, seq, carry = torch.zeros(2 * b * h, device=dev), torch.empty((b, f, h), device=dev), torch.empty((b, h), device=dev)
    nf = torch.full((b,), f, dtype=torch.int32, device=dev)
    prof = torch.zeros((2 * (h // 32) * (b // 128), len(PHASES)), dtype=torch.int64, device=dev)
    for name, no_h, no_w in (("loads", False, False), ("no_h_loads", True, False), ("no_w_loads", False, True)):
        fn = build(f"gru_phases_{name}", instrumented(no_h, no_w)).gru_phases
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        for off, what in SWITCHES.items() if name == "loads" else ((0, "nothing"), (4, "ring copies")):
            def run():
                rc = fn(pre.data_ptr(), w_h.data_ptr(), b_i.data_ptr(), b_hn.data_ptr(), hbuf.data_ptr(),
                        seq.data_ptr(), carry.data_ptr(), nf.data_ptr(), b, f, h, off, prof.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"gru_phases: CUDA error {rc}")
            for _ in range(2):
                run()
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                run()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            clocks = (prof.double().mean(0) / (f - 1)).tolist()
            print(json.dumps({"operands": name, "left_out": what, "us_a_step": float(np.median(times)) * 1e3 / f,
                              "sm_clocks_a_step": dict(zip(PHASES, (round(v) for v in clocks)))}), flush=True)


if __name__ == "__main__":
    main()
