"""What the covariance kernel and the GP fit step cost on the card, and
which tile shape serves `gp_kernel_matrix` best.  A profiling aid beside
chip_smoke.py; the port never imports it.

    python3 gp_kernel_ablation.py                # from the repo root, on a card
    python3 gp_kernel_ablation.py --src DIR      # DIR/src's package instead

Part 1, for the package under `--src` (default: this checkout's), with
chip_smoke.py's timers: the launch floor; `gp_kernel_matrix` through its
wrapper at the main path's shapes (K(X, X), d = 7: rbf n = 128, 256, 512,
2,048 and matern52 2,048; device ms); `chip_smoke.fit_step_profile` at the
main fit's shape (the GS2 thetas, LHS seed 11, n = 256, d = 7, two
outputs: sin and a product of the inputs, as the profile does not depend
on the outputs' values); and the 40-step fit of tests/test_torch_cuda.py
on the card and on the CPU (the gap of the final NLML and log-parameters).
`--src` measures another checkout the same way, e.g. a parent commit
unpacked with `git archive` into a directory `.gitignore` lists.

Part 2, this checkout only: the covariance kernels of
`src/repro_torch/kernels/csrc/gp_kernel.cu` at both of their tiles (32
and 64 rows of 32 columns, 4 and 8 rows per thread), at a 128-row tile
(16 rows per thread: the source with its large tile set to 128), and
three stage ablations of the forward (`no_exp`: the correlation replaced
by d2 itself; `store_only`: each output is the variance, nothing
computed; `no_div`: the staging multiplies by the lengthscale instead of
dividing, which changes the gradient too) at both tiles, and the source
with the library's `sqrtf` in place of `sqrt_rn_pos`.  Each source is
built into `build/repro_torch/ablation/` and called through the
library's C entries with the tile rows given (the wrapper, which picks
the tile, is not touched): the forward and the gradient held to their
plain versions (the ablations' wrong results by design are not checked),
then timed with torch.profiler at the shapes above and at 1024² and
1536² (rbf), every variant in one process on one card, in two rounds; a
row names in `event_timed` the timings the profiler missed (those are
host-bound call times, not the kernel's).  A
text not found exactly once in the source stops the script: after an
edit of the kernel, bring LARGE and STAGES up to date.

Prints one JSON line per measurement and writes them all to
`chiprun_out/gp_kernel_ablation[_<name of DIR>].json`.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke

ROOT = Path(__file__).resolve().parent
LARGE = "constexpr int kKmLargeRows = 64;"
# forward stage -> (text in the source, the text that empties it)
STAGES = {
    "no_exp": ("        v * correlation<kKind>(km_d2<D>(a, b, nb));",
               "        v * km_d2<D>(a, b, nb);"),
    "store_only": ("        v * correlation<kKind>(km_d2<D>(a, b, nb));",
                   "        v;"),
    "no_div": ("    const float v = ok ? src[c] / ls[c] : 0.0f;",
               "    const float v = ok ? src[c] * ls[c] : 0.0f;"),
}
# source name -> (text in the source, what replaces it): the same function
# another way, its results checked
ALTERNATIVES = {
    "sqrtf": ("__device__ __forceinline__ float sqrt_rn_pos(float x) {\n",
              "__device__ __forceinline__ float sqrt_rn_pos(float x) {\n"
              "  return sqrtf(x);\n"),
}
SHAPES = ((128, "rbf"), (256, "rbf"), (512, "rbf"), (2048, "rbf"),
          (2048, "matern52"))
TILE_SHAPES = SHAPES[:3] + ((1024, "rbf"), (1536, "rbf")) + SHAPES[3:]
D = 7


def emit(rows: list, **row) -> None:
    rows.append(row)
    print(json.dumps(row), flush=True)


def part1(rows: list, smi: str) -> None:
    import numpy as np
    import torch
    from repro_torch.kernels import gp_kernel, ref
    from repro_torch.uq import gp, sampling
    emit(rows, what="launch_floor", ms=chip_smoke.launch_floor_ms(),
         device=smi)
    g = torch.Generator(device="cuda").manual_seed(0)
    for n, kind in SHAPES:
        x = torch.randn(n, D, generator=g, device="cuda")
        ls = torch.exp(0.2 * torch.randn(D, generator=g, device="cuda"))
        var = torch.tensor(1.7, device="cuda")
        got = gp_kernel.gp_kernel_matrix(x, x, ls, var, kind)
        err = chip_smoke.max_err(got, ref.gp_kernel_matrix(x, x, ls, var,
                                                           kind))
        ms = chip_smoke.device_ms(
            lambda: gp_kernel.gp_kernel_matrix(x, x, ls, var, kind), 200,
            label=f"forward {kind} n={n}", expect=1)
        emit(rows, what="forward", n=n, kind=kind, ms=ms, max_abs_err=err)

    thetas = sampling.latin_hypercube(256, seed=11)
    y = np.stack([np.sin(3.0 * thetas[:, 0]), thetas[:, 1] * thetas[:, 2]],
                 1)
    emit(rows, what="fit_step_profile",
         **chip_smoke.fit_step_profile(thetas, y))

    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, (64, 3)).astype(np.float32)
    y = np.stack([np.sin(x[:, 0]), x[:, 1] * x[:, 2]], 1)
    fits = {}
    for dev in ("cuda", "cpu"):
        xt, yt = gp.as_f32(x, dev), gp.as_f32(y, dev)
        mean, std = gp._standardise(yt)
        tree, losses = gp._fit(xt, (yt - mean) / std, "rbf", 40, 5e-2)
        fits[dev] = (float(losses[-1]), {k: v.cpu() for k, v in tree.items()})
    (lc, tc), (lx, tx) = fits["cuda"], fits["cpu"]
    emit(rows, what="fit40_card_vs_cpu", nlml_card=lc, nlml_cpu=lx,
         nlml_gap=abs(lc - lx),
         param_gap={k: float((tc[k] - tx[k]).abs().max()) for k in tx},
         param_rel_gap={k: float(((tc[k] - tx[k]).abs()
                                  / (1.0 + tx[k].abs())).max()) for k in tx})


def short_name(mangled: str) -> str:
    """gp_kernel_matrix_kernel<7,0,64> for its mangled name."""
    m = re.search(r"(gp_kernel_matrix\w*?)I((?:Li\d+E)+)E", mangled)
    if not m:
        return mangled
    return f"{m.group(1)}<{','.join(re.findall(r'Li(\d+)E', m.group(2)))}>"


def ptxas_lines(log: str, mangled: str) -> list:
    """ptxas -v's resource lines of the entry functions whose mangled name
    holds `mangled` (ILi7E: the instances for D = 7), name first."""
    out, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            name = name if mangled in name else None
        elif name and ("registers" in ln or "spill" in ln):
            text = ln.split("ptxas info    :")[-1].strip()
            out.append(f"{short_name(name)}: {text}")
    return out


def sass_counts(so: str, mangled: str) -> dict:
    """Static SASS instructions of each entry function of the library
    `so` whose mangled name holds `mangled`, counted up to its last EXIT
    (the out-of-line slow paths of the IEEE division and square root come
    after it), with the MUFU, shared-memory and global-memory ones apart.
    The covariance kernels unroll every loop, so for a full tile this is
    about the instructions each thread issues.  Empty where the toolkit
    has no cuobjdump."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return {}
    text = subprocess.run([str(tool), "-sass", so], capture_output=True,
                          text=True).stdout
    out, name, body = {}, None, []

    def close():
        if name and mangled in name and body:
            last = max(i for i, op in enumerate(body) if op == "EXIT")
            ops = body[:last + 1]
            out[short_name(name)] = dict(
                total=len(ops), mufu=sum(op == "MUFU" for op in ops),
                lds=sum(op == "LDS" for op in ops),
                ldg=sum(op == "LDG" for op in ops),
                stg=sum(op == "STG" for op in ops))

    for ln in text.splitlines():
        if "Function :" in ln:
            close()
            name, body = ln.split("Function :")[1].strip(), []
        else:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_]*)", ln)
            if m and name:
                body.append(m.group(1).split(".")[0])
    close()
    return out


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gp_kernel_matrix_f32.argtypes = [p] * 5 + [i] * 5 + [p]
    lib.gp_kernel_matrix_f32.restype = i
    lib.gp_kernel_matrix_grad_f32.argtypes = [p] * 8 + [i] * 5 + [p]
    lib.gp_kernel_matrix_grad_f32.restype = i


def variants(src: str) -> dict:
    """source name -> source text."""
    for text in (LARGE,) + tuple(old for old, _ in STAGES.values()) + tuple(
            old for old, _ in ALTERNATIVES.values()):
        if src.count(text) != 1:
            raise RuntimeError(f"{text!r} not found once in the kernel's "
                               "source")
    out = {"full": src,
           "rows128": src.replace(LARGE, "constexpr int kKmLargeRows = 128;")}
    for name, (old, new) in list(STAGES.items()) + list(ALTERNATIVES.items()):
        out[name] = src.replace(old, new)
    return out


# (variant, source, tile rows, whether its results are checked)
RUNS = ([("tile32", "full", 32, True), ("tile64", "full", 64, True),
         ("tile128", "rows128", 128, True), ("sqrtf_tile32", "sqrtf", 32, True),
         ("sqrtf_tile64", "sqrtf", 64, True)]
        + [(f"{st}_tile{r}", st, r, False) for st in STAGES for r in (32, 64)])


def part2(rows: list, smi: str) -> None:
    import torch
    from repro_torch.kernels import _build, gp_kernel, ref
    src_dir = _build.BUILD_DIR / "ablation"
    src_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name, text in variants(gp_kernel.SOURCE.read_text()).items():
        path = src_dir / f"gp_kernel_{name}.cu"
        path.write_text(text)
        libs[name] = _build.Library(path, _declare)
    with ThreadPoolExecutor(len(libs)) as pool:
        cdlls = dict(zip(libs, pool.map(lambda lib: lib.load(),
                                        libs.values())))
    for name, lib in libs.items():
        emit(rows, what="build", source=name, nvcc_s=lib.info["seconds"],
             ptxas_d7=ptxas_lines(str(lib.info["log"]), "ILi7E"),
             sass_d7=sass_counts(str(lib.info["path"]), "ILi7E"))
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    emit(rows, what="clocks", sm_now_and_max=clocks.strip())

    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for n, kind in TILE_SHAPES:
        x = torch.randn(n, D, generator=g, device="cuda")
        ls = torch.exp(0.2 * torch.randn(D, generator=g, device="cuda"))
        var = torch.tensor(1.7, device="cuda")
        up = torch.randn(n, n, generator=g, device="cuda")
        out = torch.empty(n, n, device="cuda")
        g_ls = torch.empty(D, device="cuda")
        g_var = torch.empty((), device="cuda")
        want_k = ref.gp_kernel_matrix(x, x, ls, var, kind)
        want_g = ref.gp_kernel_matrix_grad(up, x, x, ls, var, kind)
        scale = ref.gp_kernel_matrix_grad(up.double().abs(), x.double(),
                                          x.double(), ls.double(),
                                          var.double(), kind)
        k = gp_kernel.KINDS[kind]
        full = {}
        for rnd in range(2):
            for name, source, tile, check in RUNS:
                cdll = cdlls[source]
                part = torch.empty(-(-n // 32) * -(-n // tile), D + 1,
                                   device="cuda")

                def fwd(cdll=cdll, tile=tile):
                    _build.raise_on(cdll.gp_kernel_matrix_f32(
                        x.data_ptr(), x.data_ptr(), ls.data_ptr(),
                        var.data_ptr(), out.data_ptr(), n, n, D, k, tile,
                        stream), name)

                def grad(cdll=cdll, tile=tile, part=part):
                    _build.raise_on(cdll.gp_kernel_matrix_grad_f32(
                        up.data_ptr(), x.data_ptr(), x.data_ptr(),
                        ls.data_ptr(), var.data_ptr(), part.data_ptr(),
                        g_ls.data_ptr(), g_var.data_ptr(), n, n, D, k, tile,
                        stream), name)

                row = dict(what="variant", variant=name, n=n, kind=kind,
                           round=rnd, device=smi)
                if rnd == 0 and check:
                    fwd()
                    grad()
                    torch.cuda.synchronize()
                    if source == "full":
                        full[tile] = (out.clone(), g_ls.clone(), g_var.clone())
                    elif tile in full:
                        # an alternative of the same function: every bit
                        row["bitwise_equal_to_full"] = all(
                            torch.equal(a, b) for a, b in
                            zip((out, g_ls, g_var), full[tile]))
                    row["fwd_err"] = chip_smoke.max_err(out, want_k)
                    row["grad_rel_err"] = max(
                        float(((a.double() - b.double()).abs() / s).max())
                        for a, b, s in zip((g_ls, g_var), want_g, scale))
                    if not (row["fwd_err"] <= 2e-5
                            and row["grad_rel_err"] <= 1e-5):
                        raise AssertionError(f"{name}: {row}")
                before = len(chip_smoke.EVENT_TIMED)
                row["fwd_ms"] = chip_smoke.device_ms(
                    fwd, 50, label=f"{name} forward n={n} {kind}", expect=1)
                by_kernel = {}
                row["grad_ms"] = chip_smoke.device_ms(
                    grad, 50, label=f"{name} grad n={n} {kind}",
                    by_kernel=by_kernel, expect=2)
                # the timings the profiler did not see are CUDA-event times
                # of back-to-back calls: the host's, not the kernel's
                row["event_timed"] = [e["label"] for e in
                                      chip_smoke.EVENT_TIMED[before:]]
                row["grad_phase_ms"] = {
                    p: sum(ms for key, (ms, _) in by_kernel.items()
                           if p in key)
                    for p in chip_smoke.GP_GRAD_PHASES}
                emit(rows, **row)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=None,
                    help="a checkout whose src/ package to measure "
                         "(default: this one's; part 2 only for this one)")
    args = ap.parse_args()
    if args.src is not None:
        sys.path.insert(0, str(args.src.resolve() / "src"))
    import torch
    from repro_torch import device
    if not torch.cuda.is_available():
        print("gp_kernel_ablation.py needs a CUDA card", file=sys.stderr)
        return 1
    device.strict_numerics()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    import repro_torch
    rows = []
    emit(rows, what="package", path=str(Path(repro_torch.__file__).parent))
    part1(rows, smi)
    if args.src is None:
        part2(rows, smi)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    suffix = f"_{args.src.resolve().name}" if args.src is not None else ""
    (out_dir / f"gp_kernel_ablation{suffix}.json").write_text(
        json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
