#!/usr/bin/env python3
"""Time the bf16 feature-attention kernels K1, K5, K6a and K6b through their
public wrappers at the shapes `chip_smoke.py` gives them, for one copy of the
PyTorch/CUDA port or for diagnostic builds of this checkout's, so that design
variants can be compared on the card in one call.

Run from the repository root on a machine with one NVIDIA GPU and ``nvcc``:

    python3 tools/torch_feat_attn_probe.py [--package-root DIR] [--iters 20]
    python3 tools/torch_feat_attn_probe.py --diagnostics

``--package-root`` names the directory that holds the
``multimodalpfn_tpu_torch`` package to time (default: this checkout), for
example a copy with one edit to `csrc/feat_attn.cu`; its kernels are built
into its own ``build/kernels``. ``--diagnostics`` makes three copies of this
checkout's package under ``build/feat_attn_diagnostics/`` and times each
beside the package itself, one process each:

* ``no_attention``: a head's outputs taken from its q|k|v accumulator (no
  scores, softmax or p·v; the outputs are wrong, the products and the
  staging are as in the real body);
* ``no_weight_feed``: the producer arrives on each weight stage without
  loading it (the stages hold stale bytes): the time without the TMA ring's
  traffic;
* ``clock``: ``clock64`` sums of block 0's phases for each consumer
  warpgroup (waiting for its x rows, for its turn and for a weight stage;
  the products, the staging and scores, the softmax, p·v, the epilogue),
  read through an extra C entry, ``mmpfn_feat_attn_clock``.

The last line is a JSON object with the card and, per build, the ms of each
shape (and the clock shares).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (name, kernel, tokens, leading dims): K1/K6a item-major (b, t, s, e), K5/K6b
# sample-major (b, s, t, e), e = 192, h = 6, d = 32
SHAPES = [("K1", "K1", 31, (4, 2350)), ("K1@t48", "K1", 48, (4, 2350)),
          ("K1@ft", "K1", 30, (1, 1838)), ("K5", "K5", 31, (4, 1838)),
          ("K5@t48", "K5", 48, (4, 1838)), ("K6a", "K6a", 48, (4, 2350)),
          ("K6b", "K6b", 48, (4, 1838)), ("K6b@predict", "K6b", 48, (4, 512))]

CLOCK_PHASES = ["x_wait", "turn_wait", "products", "staging_scores", "softmax", "pv",
                "stage_wait", "epilogue"]

_NO_ATTENTION = [
    ("""      stage_qkv();
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < D / 16; ++j) wgmma_ss_n64(sc, qd + 2 * j, kd + 2 * j, j);
      wgmma_commit();
      bar_arrive(TURN_BAR + (wg ^ 1), 256);
      wgmma_wait<0>();
      keep(sc);
    };""", """      stage_qkv();
      bar_arrive(TURN_BAR + (wg ^ 1), 256);
    };"""),
    ("""    auto softmax = [&]() {
#pragma unroll""", """    auto softmax = [&]() {};
    auto softmax_unused = [&]() {
#pragma unroll"""),
    ("""    auto weigh_values = [&]() {
      float o[D / 2];""", """    auto weigh_values = [&]() {
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) oa[j][i] = pack_bf16(qkv[8 * j + i], 0.f);
    };
    auto weigh_values_unused = [&]() {
      float o[D / 2];"""),
]
_NO_WEIGHT_FEED = [
    ("""          mbar_arrive_tx(full + s, G::STAGE);
          uint8_t* st = ring + s * G::STAGE;""", """          mbar_arrive(full + s);
          uint8_t* st = ring + s * G::STAGE;"""),
    ("""          for (int b = 0; b < G::NB; ++b) {
            tma_load(st + b * G::QBOX""", """          for (int b = 0; b < G::NB * (it < 0); ++b) {
            tma_load(st + b * G::QBOX"""),
]
_CLOCK = [
    ("""namespace wg {

constexpr int THREADS = 384;""", """namespace wg {
__device__ unsigned long long g_clock[2][10];
#define CLK(k, ...)                                                                     \\
  {                                                                                     \\
    const unsigned long long t0_ = clock64();                                           \\
    __VA_ARGS__;                                                                        \\
    if (blockIdx.x == 0 && (tid & 127) == 0) g_clock[wg][k] += clock64() - t0_;         \\
  }

constexpr int THREADS = 384;"""),
    ("""    int it = 0, xt = 0;
    for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x, ++xt, it += G::H) {""",
     """    int it = 0, xt = 0;
    const unsigned long long start_ = clock64();
    for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x, ++xt, it += G::H) {"""),
    ("      mbar_wait(xfull + wg, xt & 1);\n", "      CLK(0, mbar_wait(xfull + wg, xt & 1));\n"),
    ("""      wait_full(it);
      bar_sync(TURN_BAR + wg, 256);
      products([&] { p_qkv(it); });
      scores_then_pass();
      softmax();""", """      CLK(6, wait_full(it));
      CLK(1, bar_sync(TURN_BAR + wg, 256));
      CLK(2, products([&] { p_qkv(it); }));
      CLK(3, scores_then_pass());
      CLK(4, softmax());"""),
    ("""        wait_full(it + h);
        bar_sync(TURN_BAR + wg, 256);
        weigh_values();
        products([&] {
          p_out(it + h - 1);
          p_qkv(it + h);
        });
        release(it + h - 1);
        scores_then_pass();
        softmax();""", """        CLK(6, wait_full(it + h));
        CLK(1, bar_sync(TURN_BAR + wg, 256));
        CLK(5, weigh_values());
        CLK(2, products([&] {
          p_out(it + h - 1);
          p_qkv(it + h);
        }));
        release(it + h - 1);
        CLK(3, scores_then_pass());
        CLK(4, softmax());"""),
    ("""      bar_sync(TURN_BAR + wg, 256);
      weigh_values();
      p_out(it + G::H - 1);""", """      CLK(1, bar_sync(TURN_BAR + wg, 256));
      CLK(5, weigh_values());
      p_out(it + G::H - 1);"""),
    ("""      uint32_t xa[E / 16][4];
      x_frags<E>(xa, xs);""", """      const unsigned long long epi_ = clock64();
      uint32_t xa[E / 16][4];
      x_frags<E>(xa, xs);"""),
    ("""        mbar_arrive(xempty + wg);
      }
    }""", """        mbar_arrive(xempty + wg);
      }
      if (blockIdx.x == 0 && (tid & 127) == 0) g_clock[wg][7] += clock64() - epi_;
    }
    if (blockIdx.x == 0 && (tid & 127) == 0) g_clock[wg][9] += clock64() - start_;"""),
    ("""extern "C" int mmpfn_feat_attn_ln_wg(""",
     """// block 0's clock sums by phase and consumer warpgroup, zeroed after reading
extern "C" int mmpfn_feat_attn_clock(unsigned long long* out) {
  int rc = (int)cudaDeviceSynchronize();
  if (!rc) rc = (int)cudaMemcpyFromSymbol(out, wg::g_clock, sizeof(wg::g_clock));
  unsigned long long zero[20] = {};
  if (!rc) rc = (int)cudaMemcpyToSymbol(wg::g_clock, zero, sizeof(zero));
  return rc;
}

extern "C" int mmpfn_feat_attn_ln_wg("""),
]
DIAGNOSTICS = {"no_attention": _NO_ATTENTION, "no_weight_feed": _NO_WEIGHT_FEED, "clock": _CLOCK}


def edited_source(name: str) -> str:
    """This checkout's csrc/feat_attn.cu with diagnostic `name`'s edits
    ((old, new) text pairs) applied."""
    text = (ROOT / "multimodalpfn_tpu_torch" / "csrc" / "feat_attn.cu").read_text()
    for old, new in DIAGNOSTICS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: csrc/feat_attn.cu does not hold the text to edit once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def make_copy(name: str) -> Path:
    """This checkout's package copied to build/feat_attn_diagnostics/<name>
    with diagnostic `name`'s edits."""
    dst = ROOT / "build" / "feat_attn_diagnostics" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "multimodalpfn_tpu_torch", dst / "multimodalpfn_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    (dst / "multimodalpfn_tpu_torch" / "csrc" / "feat_attn.cu").write_text(edited_source(name))
    return dst


def case(name: str, kid: str, t: int, lead: tuple, device, seed: int = 0):
    """The kernel call of one shape, on random bf16 inputs from a seed."""
    import torch

    from multimodalpfn_tpu_torch.ops import fused

    gen = torch.Generator().manual_seed(seed)
    e, h, d = 192, 6, 32

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device)

    w_qkv, w_out = rand(3, h, d, e, scale=e**-0.5), rand(h, d, e, scale=(h * d) ** -0.5)
    b, s = lead
    # the merged group's masks (chip_smoke.py phase 2): members 39, 39, 22,
    # 22 features wide of 48 tokens, 8 image tokens and the target
    mask = torch.ones((b, t), dtype=torch.bool)
    for i in range(b):
        mask[i, (39, 39, 22, 22)[i % 4]:t - 9] = False
    if kid in ("K1", "K6a"):
        x = rand(b, t, s, e).to(torch.bfloat16)
        km = mask if kid == "K6a" else None
        return lambda: fused.fused_feature_attention_ln_im(x, w_qkv, w_out, km)
    x = rand(b, s, t, e).to(torch.bfloat16)
    km = mask[:, None] if kid == "K6b" else None
    return lambda: fused.fused_feature_attention_ln(x, w_qkv, w_out, None, km)


def time_shapes(iters: int, clock: bool) -> dict:
    import importlib.util

    import torch

    from multimodalpfn_tpu_torch.ops import kernels

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    device = torch.device("cuda")
    lib = kernels.library()
    if clock:
        lib.mmpfn_feat_attn_clock.argtypes = [ctypes.c_void_p]
        buf = (ctypes.c_ulonglong * 20)()
    out = {}
    with torch.no_grad():
        for name, kid, t, lead in SHAPES:
            fn = case(name, kid, t, lead, device)
            res = {"ms": smoke.timed(fn, device, iters)}
            if clock:
                kernels.check(lib.mmpfn_feat_attn_clock(buf), "clock")  # zero the sums
                fn()
                kernels.check(lib.mmpfn_feat_attn_clock(buf), "clock")
                for w in range(2):
                    total = buf[10 * w + 9] or 1
                    res[f"wg{w}"] = {ph: buf[10 * w + k] / total for k, ph in enumerate(CLOCK_PHASES)}
            out[name] = res
            print(f"  {name}: {res['ms']:.4f} ms" + "".join(
                f"; wg{w} " + ", ".join(f"{ph} {v:.2f}" for ph, v in res[f'wg{w}'].items())
                for w in range(2) if f"wg{w}" in res), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package-root", type=Path, default=ROOT)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--diagnostics", action="store_true",
                    help="also time no_attention, no_weight_feed and clock builds of this checkout")
    ap.add_argument("--clock", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: nothing was run", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    if args.diagnostics:
        print(f"{card}; diagnostics of {ROOT}", flush=True)
        results = {}
        for name, root in [("tree", ROOT)] + [(n, make_copy(n)) for n in DIAGNOSTICS]:
            cmd = [sys.executable, __file__, "--package-root", str(root), "--iters", str(args.iters)]
            if name == "clock":
                cmd.append("--clock")
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1200)
            print(f"== {name} (rc {proc.returncode})\n" + proc.stdout.strip(), flush=True)
            if proc.returncode != 0:
                print(proc.stderr[-3000:], file=sys.stderr)
                return 1
            results[name] = json.loads(proc.stdout.strip().splitlines()[-1])["results"]
        print(json.dumps({"card": card, "results": results}))
        return 0
    pkg_root = args.package_root.resolve()
    sys.path.insert(0, str(pkg_root))
    from multimodalpfn_tpu_torch.ops import kernels

    if not kernels.CSRC.is_relative_to(pkg_root):
        print(f"the package was imported from {kernels.CSRC}, not {pkg_root}", file=sys.stderr)
        return 2
    print(f"{card}; package {pkg_root}", flush=True)
    results = time_shapes(args.iters, args.clock)
    print(json.dumps({"card": card, "package_root": str(pkg_root), "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
