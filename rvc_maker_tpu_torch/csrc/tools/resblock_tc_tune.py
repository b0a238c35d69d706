#!/usr/bin/env python3
"""Time a tensor-core resblock kernel on the card, by stage or by `Cfg` variant.

    python3 rvc_maker_tpu_torch/csrc/tools/resblock_tc_tune.py stages [--fma] [--bf16] [--widths=C,..]
    python3 rvc_maker_tpu_torch/csrc/tools/resblock_tc_tune.py variants \\
        NAME=C,KC,MT_MAX,WM,RING,MINB,T1F,PRODUCER ...
    python3 rvc_maker_tpu_torch/csrc/tools/resblock_tc_tune.py variants --bf16 \\
        NAME=C,KC,MT_MAX,WM,RING,MINB ...

Run from the repository's root on a machine with the card (it imports
chip_smoke.py's timers).  Without --bf16: csrc/resblock_tc.cu in fp32,
TF32 off, each result held against the plain chain within 1e-4 x max(1,
|ref|max).  With --bf16: csrc/resblock_tc_bf16.cu on bf16 inputs, each
result held against the bf16 plain chain within 4 bf16 ulps of |ref|max.
Random weights from a seed, dilations 1 / 3 / 5.

stages: the v2-48k resblock stages, in conversion (B = 2, 10 s) and in
training (B = 8, a 36-frame segment): `_launch_steps`'s ms at each k
beside the cuDNN chain in the same dtype and the bound (fp32: the
3xTF32 one, with `_tc_pack` timed alone; bf16: flops at the dense bf16
rate), with --fma resblock.cu too; sums per stage and path; --widths
takes only those stages.  C = 256 in conversion is also timed at T =
11,988 (999 frames: T = 4 mod 8, the bf16 kernel's 8-byte staging and
stores), on a line of its own and out of the sums.

variants: each NAME's source is the kernel's source with its `Cfg<C>` row
replaced; all are built at once with ops/build.py's flags into
rvc_maker_tpu_torch/_build/variants/ (ptxas's registers and spills
printed), then timed at their width's conversion and training stages in
turns (a, b, ..., b, a), the kernel's tile table (`TC_TILES` or
`TC_BF16_TILES`) set to the variant's row.
"""

import ctypes
import os
import re
import subprocess
import sys

DILATIONS = (1, 3, 5)
CONVERSION = {256: 11976, 128: 119760, 64: 239520, 32: 479040, 16: 479040}
TRAINING = {256: 432, 128: 4320, 64: 8640, 32: 17280, 16: 17280}
# conversion lengths timed beside a stage's and left out of its sums
CONVERSION_ODD = {256: 11988}
# kernel -> (source, route, tile table in ops/resblock.py, `Cfg` fields,
# kernel template, step function and its pointer arguments)
KERNELS = {
    "fp32": ("resblock_tc.cu", "tc", "TC_TILES",
             ("KC", "MT_MAX", "WM", "RING", "MINB", "T1F", "PRODUCER"),
             "resblock_tc_step_kernel", "rvc_resblock_tc_step", 5),
    "bf16": ("resblock_tc_bf16.cu", "tc_bf16", "TC_BF16_TILES",
             ("KC", "MT_MAX", "WM", "RING", "MINB"),
             "resblock_tc_bf16_step_kernel", "rvc_resblock_tc_bf16_step", 6),
}


def case(gen, b, c, t, k, dtype):
    import torch

    scale = 0.5 / (k * c) ** 0.5
    x = (torch.randn(b, c, t, generator=gen) * 0.3).cuda()
    w1, w2 = ((torch.randn(3, k, c, c, generator=gen) * scale).cuda() for _ in range(2))
    b1, b2 = ((torch.randn(3, c, generator=gen) * 0.1).cuda() for _ in range(2))
    return tuple(a.to(dtype) for a in (x, w1, b1, w2, b2))


def checked_ms(rb, cs, route, args, k, iters):
    ref = rb._resblock(*args, kernel_size=k, dilations=DILATIONS).float()
    got = rb._launch_steps(route, *args, k, DILATIONS)[-1].float()
    err = (got - ref).abs().max().item()
    tol = (cs.BF16_ULPS * cs.bf16_ulp(ref.abs().max().item()) if route == "tc_bf16"
           else 1e-4 * max(1.0, ref.abs().max().item()))
    if not err <= tol:
        raise AssertionError(f"k={k}: err {err} > {tol}")
    return cs.cuda_ms(lambda: rb._launch_steps(route, *args, k, DILATIONS), iters)


def stages(rb, cs, fma: bool, kernel: str, widths=(256, 128, 64, 32)):
    import torch

    route = KERNELS[kernel][1]
    dtype = torch.bfloat16 if kernel == "bf16" else torch.float32
    gen = torch.Generator().manual_seed(0)
    for path, b, lengths in (("training", 8, TRAINING), ("conversion", 2, CONVERSION)):
        total = dict(tc=0.0, fma=0.0, library=0.0, bound=0.0)
        for c, t in [(c, lengths[c]) for c in widths] + (
                [(c, CONVERSION_ODD[c]) for c in widths if c in CONVERSION_ODD]
                if path == "conversion" else []):
            st = dict(tc=0.0, fma=0.0, library=0.0, bound=0.0)
            for k in (3, 7, 11):
                args = case(gen, b, c, t, k, dtype)
                x, w1, b1, w2, b2 = args
                ms = checked_ms(rb, cs, route, args, k, 5)
                wt1, wt2 = (w.permute(0, 3, 2, 1).contiguous() for w in (w1, w2))
                lib = cs.cuda_ms(lambda: cs.library_resblock(x, wt1, b1, wt2, b2, k, DILATIONS), 5)
                fms = cs.cuda_ms(lambda: rb._fma_resblock(*args, kernel_size=k,
                                                          dilations=DILATIONS), 5) if fma else 0.0
                flops = rb.resblock_flops(b, t, c, k, 3)
                nbytes = x.element_size() * (2 * b * c * t + w1.numel() + w2.numel() + 6 * c)
                if kernel == "bf16":
                    extra = ""
                    bound = 1e3 * max(flops / cs.H100_BF16_FLOPS, nbytes / cs.H100_BYTES_PER_S)
                else:
                    extra = f" (split {cs.cuda_ms(lambda: rb._tc_pack(w1, w2), 5):.3f})"
                    bound = cs.bounds_ms(flops, nbytes)[1]
                tt = rb.tc_time_tile(route, b, t, c, k)
                print(f"{path} {kernel} B={b} C={c} T={t} k={k}: tile {tt} x {b * -(-t // tt)} "
                      f"blocks; {route} {ms:.3f} ms{extra}, fma {fms:.3f}, cuDNN {lib:.3f}, "
                      f"bound {bound:.3f}, share {bound / ms:.3f}", flush=True)
                for key, v in (("tc", ms), ("fma", fms), ("library", lib), ("bound", bound)):
                    st[key] += v
            print(f"  {path} {kernel} stage C={c} T={t}: " + ", ".join(
                f"{k} {v:.3f}" for k, v in st.items()) + f", share {st['bound'] / st['tc']:.3f}",
                flush=True)
            if t == lengths[c]:
                for key in total:
                    total[key] += st[key]
        print(f"{path} {kernel} total: " + ", ".join(f"{k} {v:.3f}" for k, v in total.items()),
              flush=True)


def variants(rb, cs, build, specs: dict, kernel: str):
    import torch

    source, route, table_name, fields, template, step_name, n_ptr = KERNELS[kernel]
    src = open(os.path.join(build.CSRC_DIR, source)).read()
    out_dir = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, spec in specs.items():
        c, vals = spec[0], spec[1:]
        if len(vals) != len(fields):
            raise ValueError(f"{name}: C then {', '.join(fields)}")
        row = (f"template <> struct Cfg<{c}> {{ static constexpr int "
               + ", ".join(f"{f} = {v}" for f, v in zip(fields, vals)) + "; };")
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(re.sub(r"template <> struct Cfg<%d> \{[^}]*\};" % c, row, src))
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", os.path.join(out_dir, f"lib{name}.so"),
             path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        for ent in cs.resblock_ptxas(log, template):
            if ent["C"] == specs[name][0]:
                print(f"{name} C={ent['C']} k={ent['K']}: {ent['registers']} registers, spills "
                      f"{ent['spill_stores']} / {ent['spill_loads']} B", flush=True)
    dtype = torch.bfloat16 if kernel == "bf16" else torch.float32
    gen = torch.Generator().manual_seed(0)
    table = getattr(rb, table_name)         # the route's config table, set in place
    tiles = dict(table)
    for name in list(specs) + list(specs)[::-1]:
        c = specs[name][0]
        cfg = dict(zip(fields, specs[name][1:]))
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
        step = getattr(lib, step_name)
        step.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        step.restype = ctypes.c_int
        lib.rvc_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rvc_cuda_error_string.restype = ctypes.c_char_p
        rb._library = lambda route, _l=(lib, step, None): _l
        table.update(tiles)
        table[c] = (cfg["KC"], cfg["MT_MAX"], cfg["WM"], cfg["MINB"])
        res = []
        for b, t in ((2, CONVERSION[c]), (8, TRAINING[c])):
            times = []
            for k in (3, 7, 11):
                args = case(gen, b, c, t, k, dtype)
                tt = rb.tc_time_tile(route, b, t, c, k)
                times.append(checked_ms(rb, cs, route, args, k, 10))
                del args
            res.append(f"B={b} " + " / ".join(f"{v:.3f}" for v in times)
                       + f" (sum {sum(times):.3f}) ms, last tile {tt}")
        print(f"{name} {specs[name]}: " + "; ".join(res), flush=True)


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from rvc_maker_tpu_torch.ops import build
    from rvc_maker_tpu_torch.ops import resblock as rb

    if not torch.cuda.is_available():
        print("resblock_tc_tune: no card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    kernel = "bf16" if "--bf16" in sys.argv else "fp32"
    widths = [tuple(int(c) for c in a.split("=")[1].split(",")) for a in sys.argv
              if a.startswith("--widths=")]
    argv = [a for a in sys.argv[1:] if a not in ("--bf16", "--fma") and not a.startswith("--")]
    if argv[:1] == ["stages"]:
        names = [KERNELS[kernel][0][:-3]] + (["resblock"] if "--fma" in sys.argv else [])
        build.build_all(names)
        stages(rb, cs, "--fma" in sys.argv, kernel, *widths)
    elif argv[:1] == ["variants"]:
        specs = {name: tuple(int(v) for v in spec.split(","))
                 for name, spec in (a.split("=") for a in argv[1:])}
        variants(rb, cs, build, specs, kernel)
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
