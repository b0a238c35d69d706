#!/usr/bin/env python3
"""Time csrc/resblock_tc.cu on the card, by stage or by `Cfg` variant.

    python3 rvc_maker_tpu_torch/csrc/tools/resblock_tc_tune.py stages [--fma]
    python3 rvc_maker_tpu_torch/csrc/tools/resblock_tc_tune.py variants \\
        NAME=C,KC,MT_MAX,WM,RING,MINB,T1F,PRODUCER ...

Run from the repository's root on a machine with the card (it imports
chip_smoke.py's timers).  fp32, TF32 off, random weights from a seed,
dilations 1 / 3 / 5, each result held against the plain chain within
1e-4 x max(1, |ref|max).

stages: the v2-48k resblock stages, in conversion (B = 2, 10 s) and in
training (B = 8, a 36-frame segment): `_launch_steps`'s ms (the weights'
split included) at each k beside the cuDNN chain, `_tc_pack` alone and
the 3xTF32 bound; with --fma resblock.cu too; sums per stage and path.

variants: each NAME's source is csrc/resblock_tc.cu with its `Cfg<C>` row
replaced; all are built at once with ops/build.py's flags into
rvc_maker_tpu_torch/_build/variants/ (ptxas's registers and spills
printed), then timed at their width's conversion and training stages in
turns (a, b, ..., b, a), `TC_TILES[C]` set to the variant's row.
"""

import ctypes
import os
import re
import subprocess
import sys

DILATIONS = (1, 3, 5)
CONVERSION = {256: 11976, 128: 119760, 64: 239520, 32: 479040, 16: 479040}
TRAINING = {256: 432, 128: 4320, 64: 8640, 32: 17280, 16: 17280}


def case(gen, b, c, t, k):
    import torch

    scale = 0.5 / (k * c) ** 0.5
    x = (torch.randn(b, c, t, generator=gen) * 0.3).cuda()
    w1, w2 = ((torch.randn(3, k, c, c, generator=gen) * scale).cuda() for _ in range(2))
    b1, b2 = ((torch.randn(3, c, generator=gen) * 0.1).cuda() for _ in range(2))
    return x, w1, b1, w2, b2


def checked_ms(rb, cs, args, k, iters):
    ref = rb._resblock(*args, kernel_size=k, dilations=DILATIONS)
    got = rb._launch_steps("tc", *args, k, DILATIONS)[-1]
    err = (got - ref).abs().max().item()
    if not err <= 1e-4 * max(1.0, ref.abs().max().item()):
        raise AssertionError(f"k={k}: err {err}")
    return cs.cuda_ms(lambda: rb._launch_steps("tc", *args, k, DILATIONS), iters)


def stages(rb, cs, fma: bool):
    import torch

    gen = torch.Generator().manual_seed(0)
    for path, b, lengths in (("training", 8, TRAINING), ("conversion", 2, CONVERSION)):
        total = dict(tc=0.0, fma=0.0, library=0.0, bound=0.0)
        for c in (256, 128, 64, 32):
            st = dict(tc=0.0, fma=0.0, library=0.0, bound=0.0)
            t = lengths[c]
            for k in (3, 7, 11):
                args = case(gen, b, c, t, k)
                x, w1, b1, w2, b2 = args
                ms = checked_ms(rb, cs, args, k, 5)
                wt1, wt2 = (w.permute(0, 3, 2, 1).contiguous() for w in (w1, w2))
                lib = cs.cuda_ms(lambda: cs.library_resblock(x, wt1, b1, wt2, b2, k, DILATIONS), 5)
                fms = cs.cuda_ms(lambda: rb._fma_resblock(*args, kernel_size=k,
                                                          dilations=DILATIONS), 5) if fma else 0.0
                pack = cs.cuda_ms(lambda: rb._tc_pack(w1, w2), 5)
                nbytes = 4 * (2 * b * c * t + w1.numel() + w2.numel() + 6 * c)
                bound = cs.bounds_ms(rb.resblock_flops(b, t, c, k, 3), nbytes)[1]
                tt = rb.tc_time_tile(b, t, c, k)
                print(f"{path} B={b} C={c} T={t} k={k}: tile {tt} x {b * -(-t // tt)} blocks; "
                      f"tc {ms:.3f} ms (split {pack:.3f}), fma {fms:.3f}, cuDNN {lib:.3f}, "
                      f"bound {bound:.3f}, share {bound / ms:.3f}", flush=True)
                for key, v in (("tc", ms), ("fma", fms), ("library", lib), ("bound", bound)):
                    st[key] += v
            print(f"  {path} stage C={c}: " + ", ".join(f"{k} {v:.3f}" for k, v in st.items())
                  + f", share {st['bound'] / st['tc']:.3f}", flush=True)
            for key in total:
                total[key] += st[key]
        print(f"{path} total: " + ", ".join(f"{k} {v:.3f}" for k, v in total.items()), flush=True)


def variants(rb, cs, build, specs: dict):
    import torch

    src = open(os.path.join(build.CSRC_DIR, "resblock_tc.cu")).read()
    out_dir = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (c, kc, mt, wm, ring, minb, t1f, producer) in specs.items():
        row = (f"template <> struct Cfg<{c}> {{ static constexpr int KC = {kc}, MT_MAX = {mt}, "
               f"WM = {wm}, RING = {ring}, MINB = {minb}, T1F = {t1f}, PRODUCER = {producer}; }};")
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
        for ent in cs.ptxas_summary(log):
            found = re.search(r"resblock_tc_step_kernelILi(\d+)ELi(\d+)E", ent["entry"])
            if found and int(found[1]) == specs[name][0]:
                print(f"{name} C={found[1]} k={found[2]}: {ent['registers']} registers, spills "
                      f"{ent['spill_stores']} / {ent['spill_loads']} B", flush=True)
    gen = torch.Generator().manual_seed(0)
    tiles = dict(rb.TC_TILES)
    for name in list(specs) + list(specs)[::-1]:
        c, kc, mt, wm, _, minb, _, _ = specs[name]
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
        step, smem = lib.rvc_resblock_tc_step, lib.rvc_resblock_tc_smem_bytes
        step.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        step.restype = ctypes.c_int
        lib.rvc_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rvc_cuda_error_string.restype = ctypes.c_char_p
        rb._library = lambda route, _l=(lib, step, smem): _l
        rb.TC_TILES = {**tiles, c: (kc, mt, wm, minb)}
        res = []
        for b, t in ((2, CONVERSION[c]), (8, TRAINING[c])):
            times = [checked_ms(rb, cs, case(gen, b, c, t, k), k, 10) for k in (3, 7, 11)]
            res.append(f"B={b} " + " / ".join(f"{v:.3f}" for v in times)
                       + f" (sum {sum(times):.3f}) ms")
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
    if sys.argv[1:2] == ["stages"]:
        build.build_all(["resblock_tc", "resblock"] if "--fma" in sys.argv else ["resblock_tc"])
        stages(rb, cs, "--fma" in sys.argv)
    elif sys.argv[1:2] == ["variants"]:
        specs = {name: tuple(int(v) for v in spec.split(","))
                 for name, spec in (a.split("=") for a in sys.argv[2:])}
        variants(rb, cs, build, specs)
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
