"""Where the WKV kernels' time goes: their device time with one stage
taken out at a time, the forward's and the backward's.  A profiling aid
beside chip_smoke.py; the port never imports it.

    python3 wkv_ablation.py                # from the repo root, on a card
    python3 wkv_ablation.py --part bwd     # the backward's stages alone

Each variant is `src/repro_torch/kernels/csrc/rwkv6_wkv.cu` with the loop
of one stage emptied (its results are wrong by design), built into
`build/repro_torch/ablation/` with the kernels' own build, called through
the library's C entry (the port's wrapper is not touched), and timed with
torch.profiler at rwkv6-3b's prefill (S = 1024, 40 heads of 64, bf16,
seed 1) for the forward and at its train shape (B 2, S 1024, no state)
for the backward (four kernels a call; its stages are the product of the
state increments and those of the chunk gradients: the state terms'
three, do.v, A, dv, the sub-blocks and the decay's gradient), every
variant in one
process on one card, in two rounds.  The drop in a kernel's time when a
stage goes is that stage's share; `loads_only` keeps the loads, the
running sums, the barriers and the stores.  A stage whose text is not
found exactly once in the source stops the script: after an edit of the
kernel, bring STAGES and BWD_STAGES up to date.  Prints
one JSON line per variant and round and writes them all to
`chiprun_out/wkv_ablation.json`.
"""
from __future__ import annotations

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# stage -> (text in the source, the text that empties it)
STAGES = {
    "diag": ("    if (e >= kDiagExp + kC) continue;",
             "    if (e >= 0) continue;"),
    "offdiag": ("  if (half < 2) {\n    const int kh",
                "  if (half < 0) {\n    const int kh"),
    "readout": ("#pragma unroll 4\n  for (int c = 0; c < kp; c += 4) {\n"
                "    float4 a[4], bb[4];",
                "  for (int c = 0; c < 0; c += 4) {\n    float4 a[4], bb[4];"),
    "a_v": ("  for (int j = 0; j <= rt0 + 3; ++j)",
            "  for (int j = 0; j < 0; ++j)"),
    "scale": ("    s_r[t * ldk + c] *= exp2f(cprev - cpiv);\n"
              "    if (t < kKT)", "    if (t < 0)"),
    "state_product": ("#pragma unroll 4\n    for (int j = 0; j < kC; ++j)",
                      "    for (int j = 0; j < 0; ++j)"),
}
PHASES = ("wkv_chunk_state", "wkv_state_scan", "wkv_chunk_output")
# the backward's stages: the state increments' product
# (wkv_bwd_state_inc), and the chunk gradients' (wkv_bwd_chunk_grad):
# the state terms' three products, do.v, A, dv, the sub-blocks' products,
# the decay's gradient and the state terms' reads.  A stage is one (text,
# replacement) pair or a list of them.
BWD_STAGES = {
    "inc_product": ("  for (int t = 0; t < kC; ++t)\n    outer(acc, ld4(s_re",
                    "  for (int t = 0; t < 0; ++t)\n    outer(acc, ld4(s_re"),
    "sdo": ("    mma_rows(acc, sh_do, sh_sp, kPieces, ln);", ""),
    "gv": ("    mma_rows(acc, sh_v, sh_gp, kPieces, ln);", ""),
    "gk": ("    for (int ks = 0; ks < kBK / 16; ++ks)\n#pragma unroll\n"
           "      for (int ia = 0; ia < kPieces; ++ia) {",
           "    for (int ks = 0; ks < 0; ++ks)\n#pragma unroll\n"
           "      for (int ia = 0; ia < kPieces; ++ia) {"),
    "dov": ("      mma_rows(acc, smem_addr(s_do), smem_addr(s_v), 1,\n"
            "               MmaLanes(wm, wn, lane));", ""),
    "a_diag": ("    for (int tl = 1; tl < kL; ++tl) {",
               "    for (int tl = 1; tl < 0; ++tl) {"),
    "a_offdiag": ("    for (int c = 0; c < kBK; c += 4) {\n      const float4 e1",
                  "    for (int c = 0; c < 0; c += 4) {\n      const float4 e1"),
    "q_pairs": ("  if (tid < 3 * kBK) {\n    const int pq",
                "  if (tid < 0) {\n    const int pq"),
    "dv": ("    for (int t = tr; t < kC; ++t) {\n      float a[4];",
           "    for (int t = tr; t < 0; ++t) {\n      float a[4];"),
    "dk_offdiag": ("    for (int bi = kNSub - 1; bi > sb; --bi) {",
                   "    for (int bi = kNSub - 1; bi > kNSub; --bi) {"),
    "dk_diag": ("    for (int t = tr + 1; t < bend; ++t) {",
                "    for (int t = tr + 1; t < 0; ++t) {"),
    "dr_offdiag": ("    for (int bj = 0; bj < sb; ++bj) {",
                   "    for (int bj = 0; bj < 0; ++bj) {"),
    "dr_diag": ("    for (int j = tr + 2; j >= kL * sb; --j) {",
                "    for (int j = tr + 2; j >= kC; --j) {"),
    "dla_pivot": [("      for (int t = n + 1; t < kL; ++t) {\n        dd = fmaf",
                   "      for (int t = kL; t < kL; ++t) {\n        dd = fmaf"),
                  ("      for (int t = n + 2; t < kL; ++t)\n        wt[t] =",
                   "      for (int t = kL; t < kL; ++t)\n        wt[t] =")],
    "terms_reads": [
        ("      const float4 x = ld4(tb + 2 * kC * kBK + (tr + i) * kBK + vc);",
         "      const float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);"),
        ("        const float st = tb[kC * kBK + j * kBK + c];",
         "        const float st = 0.0f;"),
        ("        const float st = tb[t * kBK + c];",
         "        const float st = 0.0f;")],
}
BWD_PHASES = ("wkv_bwd_state_inc", "wkv_bwd_state_scan",
              "wkv_bwd_chunk_grad", "wkv_bwd_reduce")


def variants(src: str, stages: dict, prefix: str = "") -> dict:
    def without(*names):
        text = src
        for st in names:
            pairs = stages[st]
            for old, new in ([pairs] if isinstance(pairs, tuple) else pairs):
                if text.count(old) != 1:
                    raise RuntimeError(f"stage {st!r} not found once in the "
                                       "kernel's source")
                text = text.replace(old, new)
        return text

    out = {f"{prefix}full": src}
    out.update({f"{prefix}no_{st}": without(st) for st in stages})
    out[f"{prefix}loads_only"] = without(*stages)
    return out


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("fwd", "bwd", "both"), default="both")
    part = ap.parse_args().part
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import device
    from repro_torch.kernels import _build
    from repro_torch.kernels import rwkv6_wkv as wkv
    if not torch.cuda.is_available():
        print("wkv_ablation.py needs a CUDA card", file=sys.stderr)
        return 1
    device.strict_numerics()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    src_dir = _build.BUILD_DIR / "ablation"
    src_dir.mkdir(parents=True, exist_ok=True)
    libs, src = {}, wkv.SOURCE.read_text()
    todo = {}
    if part in ("fwd", "both"):
        todo.update(variants(src, STAGES))
    if part in ("bwd", "both"):
        todo.update(variants(src, BWD_STAGES, "bwd_"))
    for name, text in todo.items():
        path = src_dir / f"rwkv6_wkv_{name}.cu"
        path.write_text(text)
        libs[name] = _build.Library(path, wkv._declare)
    with ThreadPoolExecutor(len(libs)) as pool:
        cdlls = dict(zip(libs, pool.map(lambda lib: lib.load(),
                                        libs.values())))

    g = torch.Generator(device="cuda").manual_seed(1)
    b, s, h, kd, bf16 = 1, 1024, 40, 64, torch.bfloat16
    r, k, v = (torch.randn(b, s, h, kd, generator=g, device="cuda").to(bf16)
               for _ in range(3))
    w = torch.exp(-torch.exp(0.5 * torch.randn(b, s, h, kd, generator=g,
                                               device="cuda") - 1.0))
    u = torch.randn(h, kd, generator=g, device="cuda").to(bf16)
    out = torch.empty_like(v)
    final = torch.empty((b, h, kd, kd), dtype=torch.float32, device="cuda")
    ds, clast = wkv.scratch(b, s, h, kd, kd, "cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call(cdll):
        err = cdll.rwkv6_wkv_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None, out.data_ptr(), final.data_ptr(),
            ds.data_ptr(), clast.data_ptr(), b, s, h, kd, kd,
            wkv.DTYPES[bf16], stream)
        _build.raise_on(err, "rwkv6_wkv")

    # the backward at the train shape, from the unchanged forward's states
    bb = 2
    br, bk, bv, bdo = (torch.randn(bb, s, h, kd, generator=g, device="cuda")
                       .to(bf16) for _ in range(4))
    bw = torch.exp(-torch.exp(0.5 * torch.randn(bb, s, h, kd, generator=g,
                                                device="cuda") - 1.0))
    _, _, states = wkv.rwkv6_wkv(br, bk, bv, bw, u, None, return_states=True)
    grads = [torch.empty_like(t) for t in (br, bk, bv, bw, u)]
    work = torch.empty(wkv.bwd_scratch(bb, s, h, kd, kd),
                       dtype=torch.float32, device="cuda")

    def call_bwd(cdll):
        err = cdll.rwkv6_wkv_bwd(
            br.data_ptr(), bk.data_ptr(), bv.data_ptr(), bw.data_ptr(),
            u.data_ptr(), bdo.data_ptr(), states.data_ptr(), None,
            *(t.data_ptr() for t in grads), None, work.data_ptr(), bb, s, h,
            kd, kd, wkv.DTYPES[bf16], stream)
        _build.raise_on(err, "rwkv6_wkv_bwd")

    rows, iters = [], 20
    for rnd in range(2):
        for name, cdll in cdlls.items():
            bwd = name.startswith("bwd_")
            fn, phases = (call_bwd, BWD_PHASES) if bwd else (call, PHASES)
            for _ in range(3):
                fn(cdll)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn(cdll)
                torch.cuda.synchronize()
            ev = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
            ms = {p: sum(e.self_device_time_total for e in ev
                         if p in e.key) / 1e3 / iters for p in phases}
            row = dict(variant=name, round=rnd, ms=ms,
                       total_ms=sum(ms.values()), device=smi)
            rows.append(row)
            print(json.dumps(row), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "wkv_ablation.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
