"""Where the batched GP predict's time goes: each kernel's device time,
and the triangular product's with its FMAs or its panel loads taken out.
A profiling aid beside chip_smoke.py; the port never imports it.

    python3 gp_predict_ablation.py     # from the repo root, on a card

Each variant is `src/repro_torch/kernels/csrc/gp_kernel.cu` with one
stage of `gp_predict_tri` emptied (its results are wrong by design):
`no_fma` keeps the cp.async panel copies and the barriers, `no_loads`
copies only each panel group's first panel and multiplies whatever the
buffers hold.
Each is built into `build/repro_torch/ablation/` with the kernels' own
build, called through the library's C entry (the port's wrapper is not
touched), and timed with torch.profiler at the shapes chip_smoke.py
measures (and two between them), seed 0, every variant in one process on
one card, in two rounds; a window the profiler returns empty is taken
again, up to three times.  A text not found exactly once in the source
stops the script: after an edit of the kernel, bring STAGES up to date.
Prints one JSON line per (shape, variant, round) and writes them all to
`chiprun_out/gp_predict_ablation.json`.
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
    "fma": ("#pragma unroll\n    for (int kk = 0; kk < kB; kk += 4) {",
            "    for (int kk = 0; kk < 0; kk += 4) {"),
    "loads": ("    if (i + kStages - 1 < np)\n      load(",
              "    if (false)\n      load("),
}
PHASES = ("gp_predict_k0", "gp_predict_tri", "gp_predict_reduce")
# (experts, training rows, queries, outputs)
SHAPES = ((1, 256, 1024, 2), (1, 1024, 1024, 2), (1, 1536, 1024, 2),
          (1, 2048, 1024, 2), (64, 128, 1024, 1))


def variants(src: str) -> dict:
    out = {"full": src}
    for st, (old, new) in STAGES.items():
        if src.count(old) != 1:
            raise RuntimeError(f"stage {st!r} not found once in the "
                               "kernel's source")
        out[f"no_{st}"] = src.replace(old, new)
    return out


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import device
    from repro_torch.kernels import _build, gp_kernel, ref
    if not torch.cuda.is_available():
        print("gp_predict_ablation.py needs a CUDA card", file=sys.stderr)
        return 1
    device.strict_numerics()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    src_dir = _build.BUILD_DIR / "ablation"
    src_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name, text in variants(gp_kernel.SOURCE.read_text()).items():
        path = src_dir / f"gp_kernel_{name}.cu"
        path.write_text(text)
        libs[name] = _build.Library(path, gp_kernel._declare)
    with ThreadPoolExecutor(len(libs)) as pool:
        cdlls = dict(zip(libs, pool.map(lambda lib: lib.load(),
                                        libs.values())))

    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows_out, iters = [], 20
    for e, n, s, m in SHAPES:
        d = 7
        xt = torch.randn(e, n, d, generator=g, device="cuda")
        xs = torch.randn(e, s, d, generator=g, device="cuda")
        ls = 2.0 * torch.exp(0.2 * torch.randn(d, generator=g,
                                               device="cuda"))
        var = torch.tensor(1.3, device="cuda")
        alpha = torch.randn(e, n, m, generator=g, device="cuda")
        eye = torch.eye(n, device="cuda")
        chol = torch.linalg.cholesky(ref.gp_kernel_matrix(xt, xt, ls, var)
                                     + 1e-2 * eye)
        linv = torch.linalg.solve_triangular(chol, eye.expand(e, n, n),
                                             upper=False).contiguous()
        mean = torch.empty((e, s, m), device="cuda")
        qf = torch.empty((e, s), device="cuda")
        scratch = [torch.empty(shape, device="cuda") for shape in
                   gp_kernel.predict_scratch(e, n, s, m).values()]

        def call(cdll):
            err = cdll.gp_predict_f32(
                xt.data_ptr(), xs.data_ptr(), ls.data_ptr(),
                alpha.data_ptr(), linv.data_ptr(), var.data_ptr(),
                mean.data_ptr(), qf.data_ptr(),
                *(t.data_ptr() for t in scratch), e, n, s, d, m,
                gp_kernel.KINDS["rbf"], stream)
            _build.raise_on(err, "gp_predict")

        for rnd in range(2):
            for name, cdll in cdlls.items():
                for _ in range(3):
                    call(cdll)
                torch.cuda.synchronize()
                for _ in range(3):
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        for _ in range(iters):
                            call(cdll)
                        torch.cuda.synchronize()
                    ev = [x for x in prof.key_averages()
                          if x.device_type == DeviceType.CUDA]
                    ms = {p: sum(x.self_device_time_total for x in ev
                                 if p in x.key) / 1e3 / iters
                          for p in PHASES}
                    if all(v > 0 for v in ms.values()):
                        break
                row = dict(shape=dict(e=e, n=n, s=s, m=m), variant=name,
                           round=rnd, ms=ms, total_ms=sum(ms.values()),
                           device=smi)
                rows_out.append(row)
                print(json.dumps(row), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "gp_predict_ablation.json").write_text(
        json.dumps(rows_out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
