"""Training A/B with its loss trajectories overlaid.

Trains the same small corpus twice through `cli train --bf16`: a base arm
with an environment switch at "0" and a variant arm with it at the given
value (default RVC_TPU_BF16_SPEC=1, the bf16 spectrogram feed, whose mel
target then comes from bf16-rounded spectrogram values), and overlays
their per-epoch generator and discriminator losses.  Each arm is a CLI
process of its own, so the switch applies cleanly; the corpus
(`e2e_train.gen_dataset`, 6 s files), preprocessing and extraction (yin,
a random HuBERT) run once, at v2 / 32 kHz, and are shared.

    python -m rvc_maker_tpu_torch.tools.train_ab_overlay [--workdir DIR]
        [--files 6] [--epochs 8] [--batch-size 4] [--env KEY=VAL] [--cpu]

Writes <workdir>/overlay.json (the trajectories too) and prints one
JSON line.  Every CLI call runs on the card unless --cpu.  The default
workdir is ab_overlay under the system's temporary directory.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys

import numpy as np

from . import e2e_train

SR = 32000


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def cli(args, log_path, a, extra_env=None):
    """One CLI call through `e2e_train.CLI`, --device cpu under --cpu
    where the subcommand takes it (preprocess does not)."""
    dev = ["--device", "cpu"] if a.cpu and args[0] != "preprocess" else []
    e2e_train.cli(args + dev, log_path=log_path, extra_env=extra_env)


def run_arm(name: str, a, extra_env: dict) -> dict:
    exp = os.path.join(a.workdir, f"exp_{name}")
    if os.path.isdir(exp):
        shutil.rmtree(exp)
    shutil.copytree(os.path.join(a.workdir, "exp_shared"), exp)
    tlog = os.path.join(exp, "train.log")
    log(f"arm {name}: training {a.epochs} epochs (env {extra_env}) ...")
    cli(["train", "--exp-dir", exp, "--sample-rate", str(SR), "--epochs", str(a.epochs),
         "--batch-size", str(a.batch_size), "--bf16", "--no-pretrained",
         "--save-every-epoch", "1000"], tlog, a, extra_env)
    txt = open(tlog, errors="replace").read()
    out = {}
    for key in ("loss_g", "loss_d", "loss_mel"):
        out[key] = [float(m) for m in re.findall(rf"'{key}': ([0-9.]+)", txt)]
    # short runs never reach log_interval (200) steps: there the per-epoch
    # histories of training_data.json (the overtraining detector's, written
    # every epoch) are the record
    tdj = os.path.join(exp, "training_data.json")
    if os.path.exists(tdj):
        d = json.load(open(tdj))
        if len(d.get("loss_gen_history", [])) >= len(out["loss_g"]):
            out["loss_g"] = [float(x) for x in d["loss_gen_history"]]
            out["loss_d"] = [float(x) for x in d["loss_disc_history"]]
    if not out["loss_g"]:
        # the `epoch N done` lines carry G and D too
        out["loss_g"] = [float(m) for m in re.findall(r"loss_g ([0-9.]+)", txt)]
        out["loss_d"] = [float(m) for m in re.findall(r"loss_d ([0-9.]+)", txt)]
    if not out["loss_g"]:
        raise RuntimeError(f"arm {name}: no loss lines in {tlog}\n{txt[-2000:]}")
    # every epoch's loss_g from its `epoch N done` line (epoch 1 included,
    # which the detector's history leaves out)
    out["epoch_loss_g"] = [float(m) for m in
                           re.findall(r"epoch \d+ done .* loss_g ([-0-9.naif]+)", txt)]
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m rvc_maker_tpu_torch.tools.train_ab_overlay")
    ap.add_argument("--workdir", default=e2e_train.default_workdir("ab_overlay"))
    ap.add_argument("--files", type=int, default=6)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--env", default="RVC_TPU_BF16_SPEC=1",
                    help="variant arm env toggle, KEY=VAL")
    return ap


def main(argv=None) -> dict:
    a = build_parser().parse_args(argv)
    a.workdir = os.path.abspath(a.workdir)
    os.makedirs(a.workdir, exist_ok=True)
    shared = os.path.join(a.workdir, "exp_shared")
    if not os.path.isdir(shared):
        log("shared prep: dataset gen + preprocess + extract ...")
        ds = os.path.join(a.workdir, "dataset")
        e2e_train.gen_dataset(ds, a.files, seconds=6.0)
        os.makedirs(shared, exist_ok=True)
        cli(["preprocess", "--dataset", ds, "--exp-dir", shared, "--sample-rate", str(SR)],
            os.path.join(a.workdir, "prep.log"), a)
        cli(["extract", "--exp-dir", shared, "--sample-rate", str(SR), "--f0-method", "yin"],
            os.path.join(a.workdir, "prep.log"), a)

    key, val = a.env.split("=", 1)
    base = run_arm("base", a, {key: "0"})
    var = run_arm("variant", a, {key: val})

    n = min(len(base["loss_g"]), len(var["loss_g"]))
    bg, vg = np.asarray(base["loss_g"][:n]), np.asarray(var["loss_g"][:n])
    k = max(1, n // 4)
    tail_delta = float(vg[-k:].mean() - bg[-k:].mean())
    rel = float(abs(tail_delta) / max(bg[-k:].mean(), 1e-9))
    out = {
        "metric": "train_ab_loss_overlay",
        "env": a.env,
        "points_compared": n,
        "loss_g_tail_base": round(float(bg[-k:].mean()), 3),
        "loss_g_tail_variant": round(float(vg[-k:].mean()), 3),
        "tail_delta": round(tail_delta, 3),
        "tail_rel": round(rel, 4),
        "both_decreasing": bool(bg[-1] < bg[0] and vg[-1] < vg[0]),
    }
    with open(os.path.join(a.workdir, "overlay.json"), "w") as f:
        json.dump({**out, "base": base, "variant": var}, f, indent=2)
    print(json.dumps(out), flush=True)
    return {**out, "base": base, "variant": var}


if __name__ == "__main__":
    main()
