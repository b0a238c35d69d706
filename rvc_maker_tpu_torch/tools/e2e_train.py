"""End-to-end training run through the port's command line.

The flow a user drives (dataset -> preprocess -> extract -> index ->
train -> convert), with a preemption part-way: a voiced synthetic corpus
made from a seed, `cli preprocess`, `cli extract` (yin; the features from
a random HuBERT drawn from seed 0), `cli index`, `cli train --bf16` in
the background until `epoch N done` appears in its log, a SIGTERM (the
trainer saves `ckpt_latest.pt` and exits 0), the params digest of that
checkpoint computed in another process, the resumed `cli train`, whose
log line `resume params_g sha256=<hex> step=<n>` (RVC_TPU_RESUME_HASH)
must show the same digest and step, and `cli convert` with the last
exported `.pth` on a 5 s vibrato tone.  What it found goes to
<workdir>/SUMMARY.json and one log line.

    python -m rvc_maker_tpu_torch.tools.e2e_train run [--workdir DIR]
        [--files 60] [--epochs 120] [--batch-size 32] [--kill-epoch 60]
        [--save-every 25] [--cpu]
    python -m rvc_maker_tpu_torch.tools.e2e_train gen [--workdir DIR] [--files 60]

Every CLI call runs on the card; --cpu passes `--device cpu` to each
one that takes it.  Without --cpu and without a card the first of them
fails.  The default workdir is e2e_train under the system's temporary
directory.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SR = 48000
# the command prefix of every CLI call (a test points it at a narrowed CLI)
CLI = [sys.executable, "-u", "-m", "rvc_maker_tpu_torch.cli"]
EPOCH_DONE = re.compile(r"epoch (\d+) done")
RESUME_LINE = re.compile(r"resume params_g sha256=(\w+) step=(\d+)")
POLL_S = 0.05


def log(msg: str) -> None:
    print(f"[e2e {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def default_workdir(name: str = "e2e_train") -> str:
    return os.path.join(tempfile.gettempdir(), name)


# ---------------------------------------------------------------------------
# the corpus (host only, numpy)
# ---------------------------------------------------------------------------

def gen_dataset(root: str, n_files: int, seconds: float = 10.0, seed: int = 0) -> None:
    """Voice-like synthetic corpus under root/0: a harmonic stack with a
    base f0 per file, slow vibrato and drift, a formant-shaped envelope
    and breath noise, 16-bit WAVs at 48 kHz."""
    from ..utils.audio import save_wav

    rs = np.random.RandomState(seed)
    spk_dir = os.path.join(root, "0")
    os.makedirs(spk_dir, exist_ok=True)
    t = np.arange(int(SR * seconds)) / SR
    for i in range(n_files):
        base = 140.0 + 160.0 * rs.rand()
        vib = 1.0 + 0.03 * np.sin(2 * np.pi * (4.5 + rs.rand()) * t)
        drift = 1.0 + 0.08 * np.sin(2 * np.pi * 0.2 * t + rs.rand() * 6.28)
        f0 = base * vib * drift
        phase = 2 * np.pi * np.cumsum(f0) / SR
        formants = (500 + 300 * rs.rand(), 1500 + 500 * rs.rand(), 2500 + 500 * rs.rand())
        audio = np.zeros_like(t)
        for h in range(1, 12):
            fh = base * h
            amp = sum(np.exp(-((fh - fm) / 400.0) ** 2) for fm in formants)
            audio += (amp + 0.15) / h * np.sin(h * phase)
        env = 0.6 + 0.4 * np.sin(2 * np.pi * 0.7 * t + rs.rand() * 6.28)
        audio = audio * env
        audio += 0.01 * rs.randn(len(t))
        audio = (0.5 * audio / np.max(np.abs(audio))).astype(np.float32)
        save_wav(os.path.join(spk_dir, f"s{i:03d}.wav"), audio, SR)
    log(f"dataset: {n_files} x {seconds}s voiced files at {SR} Hz -> {root}")


# ---------------------------------------------------------------------------
# CLI subprocesses
# ---------------------------------------------------------------------------

def _env(extra: dict | None = None) -> dict:
    """This process's environment with the repository on PYTHONPATH."""
    return dict(os.environ, **(extra or {}), PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))


def cli(args: list[str], log_path: str | None = None, extra_env: dict | None = None,
        background: bool = False):
    """`CLI + args` in a subprocess from the repository root, its output
    appended to log_path.  background: return the Popen at once; else
    wait, and raise with the log's tail on a non-zero exit."""
    out = open(log_path, "ab") if log_path else None
    p = subprocess.Popen(CLI + args, cwd=REPO, env=_env(extra_env), stdout=out,
                         stderr=subprocess.STDOUT if out else None)
    if out:
        out.close()
    if background:
        return p
    rc = p.wait()
    if rc != 0:
        tail = open(log_path, errors="replace").read()[-4000:] if log_path else ""
        raise RuntimeError(f"CLI {' '.join(args[:2])} failed rc={rc}\n{tail}")
    return p


_HASH_CODE = """
import sys, torch
from rvc_maker_tpu_torch.pipelines.train_loop import params_hash
ckpt = torch.load(sys.argv[1], map_location="cpu", weights_only=False)
print(params_hash(ckpt["params_g"]), int(ckpt["step"]))
"""


def ckpt_hash_offprocess(exp_dir: str) -> tuple[str, int]:
    """sha256 of params_g in exp_dir/ckpt_latest.pt and its step, read in a
    process of its own on the CPU (the digest a resume logs under
    RVC_TPU_RESUME_HASH, `train_loop.state_params_hash`)."""
    r = subprocess.run([sys.executable, "-c", _HASH_CODE,
                        os.path.join(exp_dir, "ckpt_latest.pt")],
                       cwd=REPO, env=_env(), capture_output=True, text=True, timeout=1800)
    if r.returncode != 0:
        raise RuntimeError(f"checkpoint digest failed:\n{r.stderr[-4000:]}")
    digest, step = r.stdout.split()[-2:]
    return digest, int(step)


def wait_for_epoch(log_path: str, epoch: int, proc, timeout_s: float = 7200) -> int:
    """Block until `epoch N done` with N >= epoch appears in the log."""
    t0 = time.time()
    last = 0
    while time.time() - t0 < timeout_s:
        txt = open(log_path, errors="replace").read() if os.path.exists(log_path) else ""
        ms = EPOCH_DONE.findall(txt)
        if ms:
            last = int(ms[-1])
            if last >= epoch:
                return last
        if proc.poll() is not None:
            raise RuntimeError(f"trainer exited early rc={proc.returncode}; tail:\n"
                               + txt[-3000:])
        time.sleep(POLL_S)
    raise TimeoutError(f"epoch {epoch} not reached in {timeout_s}s (last seen: {last})")


def write_random_hubert(path: str, seed: int = 0) -> str:
    """The random HuBERT that `cli extract` draws without --embedder-path
    (seed 0), as a fairseq .pt, for `cli convert --hubert-path`."""
    import torch

    from ..interop import from_jax

    torch.save({"model": from_jax.hubert_state_dict(from_jax.random_hubert_tree(seed=seed))},
               path)
    return path


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def run(a) -> dict:
    from ..utils.audio import read_wav, save_wav

    wd = os.path.abspath(a.workdir)
    ds = os.path.join(wd, "dataset")
    exp = os.path.join(wd, "exp")
    os.makedirs(exp, exist_ok=True)
    dev = ["--device", "cpu"] if a.cpu else []
    summary: dict = {"workdir": wd, "batch_size": a.batch_size, "epochs": a.epochs,
                     "device": "cpu" if a.cpu else "cuda", "stages": {}}

    class stage:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            self.t0 = time.time()
            log(f"stage {self.name} ...")

        def __exit__(self, *exc):
            if exc[0] is None:
                dt = time.time() - self.t0
                summary["stages"][self.name] = round(dt, 1)
                log(f"stage {self.name} done in {dt:.1f}s")

    if not os.path.isdir(os.path.join(ds, "0")):
        with stage("gen"):
            gen_dataset(ds, a.files)

    with stage("preprocess"):
        cli(["preprocess", "--dataset", ds, "--exp-dir", exp, "--sample-rate", str(SR)],
            log_path=os.path.join(exp, "preprocess.log"))
    summary["segments"] = len(os.listdir(os.path.join(exp, "sliced_audios")))
    log(f"{summary['segments']} segments")

    with stage("extract"):
        cli(["extract", "--exp-dir", exp, "--sample-rate", str(SR), "--f0-method", "yin",
             *dev], log_path=os.path.join(exp, "extract.log"))

    with stage("index"):
        cli(["index", "--exp-dir", exp, *dev], log_path=os.path.join(exp, "index.log"))

    train_args = ["train", "--exp-dir", exp, "--sample-rate", str(SR),
                  "--epochs", str(a.epochs), "--batch-size", str(a.batch_size), "--bf16",
                  "--no-pretrained", "--save-every-epoch", str(a.save_every),
                  "--overtraining-threshold", "60", "--cache-data", "--model-name", "e2e",
                  "--model-author", "rvc_maker_tpu_torch-e2e", *dev]
    tlog = os.path.join(exp, "train.log")
    henv = {"RVC_TPU_RESUME_HASH": "1"}

    with stage("train_phase_a"):
        p = cli(train_args, log_path=tlog, extra_env=henv, background=True)
        try:
            reached = wait_for_epoch(tlog, a.kill_epoch, p)
            log(f"epoch {reached} reached -> SIGTERM (preemption)")
            p.send_signal(signal.SIGTERM)
            rc = p.wait(timeout=1800)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        summary["phase_a_rc"] = rc
        if rc != 0:
            raise RuntimeError(f"phase A trainer rc={rc}")
    if not os.path.isfile(os.path.join(exp, "ckpt_latest.pt")):
        raise RuntimeError("no checkpoint after SIGTERM")

    with stage("ckpt_hash"):
        disk_hash, disk_step = ckpt_hash_offprocess(exp)
        summary["ckpt_step_at_kill"] = disk_step
        summary["ckpt_sha256"] = disk_hash
        log(f"on-disk checkpoint: step {disk_step} sha256 {disk_hash[:16]}...")

    with stage("train_phase_b"):
        cli(train_args, log_path=tlog, extra_env=henv)
    txt = open(tlog, errors="replace").read()
    m = RESUME_LINE.findall(txt)
    if not m:
        raise RuntimeError("no resume-hash line in phase B log")
    summary["resume_sha256"], summary["resume_step"] = m[-1][0], int(m[-1][1])
    summary["resume_byte_exact"] = (summary["resume_sha256"] == disk_hash
                                    and summary["resume_step"] == disk_step)
    log(f"resume byte-exact: {summary['resume_byte_exact']}")
    # each epoch's `epoch N done` line, over both trainer runs
    summary["epochs_done"] = sorted({int(e) for e in EPOCH_DONE.findall(txt)})

    tj = json.load(open(os.path.join(exp, "training_data.json")))
    g = tj["smoothed_loss_gen_history"]
    summary["epochs_logged"] = len(g)
    summary["smoothed_g_first"] = round(g[0], 4)
    summary["smoothed_g_last"] = round(g[-1], 4)
    summary["g_decreasing"] = g[-1] < g[0]
    raw_g = tj["loss_gen_history"]
    k = min(5, len(raw_g))
    summary["raw_g_first5_mean"] = round(sum(raw_g[:k]) / k, 4)
    summary["raw_g_last5_mean"] = round(sum(raw_g[-k:]) / k, 4)

    pths = [f for f in os.listdir(exp) if f.endswith(".pth")]
    if not pths:
        raise RuntimeError("no exported inference weights")
    pth = os.path.join(exp, max(pths, key=lambda f: os.path.getmtime(os.path.join(exp, f))))
    summary["exported_pth"] = os.path.basename(pth)
    idx = [f for f in os.listdir(exp) if f.endswith(".index.npz")]

    with stage("convert"):
        t = np.arange(SR * 5) / SR
        f0 = 200 * (1 + 0.05 * np.sin(2 * np.pi * 5 * t))
        test_in = (0.4 * np.sin(2 * np.pi * np.cumsum(f0) / SR)).astype(np.float32)
        in_wav = os.path.join(wd, "convert_in.wav")
        out_wav = os.path.join(wd, "convert_out.wav")
        save_wav(in_wav, test_in, SR)
        hubert = write_random_hubert(os.path.join(wd, "hubert_random.pt"))
        cargs = ["convert", "--input", in_wav, "--output", out_wav, "--model", pth,
                 "--hubert-path", hubert, "--f0-method", "yin", "--pitch", "0", *dev]
        if idx:
            cargs += ["--index", os.path.join(exp, idx[0]), "--index-rate", "0.5"]
        cli(cargs, log_path=os.path.join(exp, "convert.log"))
        out, osr = read_wav(out_wav)
        summary["convert_out_sr"] = osr
        summary["convert_out_sec"] = round(len(out) / osr, 2)
        summary["convert_out_std"] = float(np.std(out))
        summary["convert_finite"] = bool(np.isfinite(out).all())

    with open(os.path.join(wd, "SUMMARY.json"), "w") as f:
        json.dump(summary, f, indent=2)
    log("SUMMARY: " + json.dumps(summary))
    return summary


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m rvc_maker_tpu_torch.tools.e2e_train")
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("gen")
    g.add_argument("--workdir", default=default_workdir())
    g.add_argument("--files", type=int, default=60)
    r = sub.add_parser("run")
    r.add_argument("--workdir", default=default_workdir())
    r.add_argument("--files", type=int, default=60)
    r.add_argument("--epochs", type=int, default=120)
    r.add_argument("--batch-size", type=int, default=32)
    r.add_argument("--kill-epoch", type=int, default=60)
    r.add_argument("--save-every", type=int, default=25)
    r.add_argument("--cpu", action="store_true", help="--device cpu on every CLI call")
    return ap


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    if a.cmd == "gen":
        gen_dataset(os.path.join(os.path.abspath(a.workdir), "dataset"), a.files)
    else:
        run(a)
    return 0


if __name__ == "__main__":
    sys.exit(main())
