"""A SIGTERM that reaches one of two training ranks stops both
(`pipelines/train_loop.py`): the ranks agree on the stop flag with a
MAX all-reduce after every step, leave the batch loop at the same step,
save one checkpoint and exit 0.

Two gloo ranks on the CPU, each a subprocess running this file with
its rank; the parent sends SIGTERM to rank 1 once it has taken its
first step.  Every wait is bounded: the process group's timeout is 30 s
and the ranks are killed after 110 s, so a hang fails the test instead
of holding the suite.  Imports no JAX.
"""

import datetime
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch

HOP, SEG = 64, 8
N_ITEMS, ROWS, EPOCHS = 8, 2, 100       # 2 steps per epoch; far more than the test runs
RANK_TIMEOUT_S = 110
PG_TIMEOUT = datetime.timedelta(seconds=30)


def _cfg():
    from rvc_maker_tpu_torch import config as tconfig

    model = dict(spec_channels=129, segment_size=SEG, inter_channels=32, hidden_channels=32,
                 filter_channels=64, n_heads=2, n_layers=1, kernel_size=3,
                 resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
                 upsample_rates=(4, 4, 2, 2), upsample_initial_channel=32,
                 upsample_kernel_sizes=(8, 8, 4, 4), spk_embed_dim=4, gin_channels=16,
                 sr=16000, use_f0=True, text_enc_hidden_dim=96)
    return tconfig.RVCConfig(
        version="v2", train=tconfig.TrainConfig(segment_size=SEG * HOP, log_interval=1000),
        data=tconfig.DataConfig(sample_rate=16000, filter_length=256, hop_length=HOP,
                                win_length=256, n_mel_channels=32),
        model=tconfig.ModelConfig(**model))


def _write_exp(exp: str) -> None:
    from rvc_maker_tpu_torch.utils.audio import save_wav

    rs = np.random.RandomState(0)
    for sub in ("wavs", "feats", "f0", "f0nsf"):
        os.makedirs(os.path.join(exp, sub), exist_ok=True)
    rows = []
    for i in range(N_ITEMS):
        frames = int(rs.randint(110, 190))
        wav = os.path.join(exp, "wavs", f"{i}.wav")
        save_wav(wav, (rs.randn(frames * HOP) * 0.1).astype(np.float32), 16000, "float32")
        np.save(wav.replace(".wav", ".spec.npy"),
                np.abs(rs.randn(frames + 1, 129)).astype(np.float32))
        paths = [os.path.join(exp, d, f"{i}.npy") for d in ("feats", "f0", "f0nsf")]
        np.save(paths[0], rs.randn(frames // 2 + 1, 96).astype(np.float32))
        np.save(paths[1], rs.randint(1, 256, frames).astype(np.int32))
        np.save(paths[2], (rs.rand(frames) * 200 + 80).astype(np.float32))
        rows.append("|".join([wav] + paths + [str(i % 2)]))
    with open(os.path.join(exp, "filelist.txt"), "w") as f:
        f.write("\n".join(rows))


def rank_main(rank: int, work: str) -> None:
    """One rank: train() for EPOCHS, writing `stepped{rank}` after its
    first step and `done{rank}` (the final step) when train() returns.
    Rank 1 then waits for the parent's `sent` (written after its SIGTERM),
    so the signal lands after the first step however fast the steps run."""
    torch.set_num_threads(2)
    from rvc_maker_tpu_torch.parallel import distributed as dist_mod
    from rvc_maker_tpu_torch.pipelines import train as train_mod
    from rvc_maker_tpu_torch.pipelines import train_loop

    dist_mod.TIMEOUT = PG_TIMEOUT
    make_step = train_mod.make_sharded_train_step

    def counted_step(*a, **kw):
        step_fn = make_step(*a, **kw)
        calls = []

        def step(state, batch):
            out = step_fn(state, batch)
            calls.append(1)
            if len(calls) == 1:
                open(os.path.join(work, f"stepped{rank}"), "w").close()
                while rank == 1 and not os.path.exists(os.path.join(work, "sent")):
                    time.sleep(0.01)
            return out

        return step

    train_mod.make_sharded_train_step = counted_step
    state = train_loop.train(os.path.join(work, "exp"), _cfg(), total_epochs=EPOCHS,
                             batch_size=ROWS, save_every_epoch=EPOCHS,
                             overtraining_detector=False, log_writer=lambda *a: None,
                             device="cpu", disc_width_div=16)
    with open(os.path.join(work, f"done{rank}"), "w") as f:
        f.write(str(state.step))
    dist_mod.shutdown()


def test_sigterm_to_one_rank_stops_both(tmp_path):
    work = str(tmp_path)
    _write_exp(os.path.join(work, "exp"))
    env = dict(os.environ, RVC_COORDINATOR_ADDRESS=f"file://{work}/store",
               RVC_NUM_PROCESSES="2", PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), work],
                              env=dict(env, RVC_PROCESS_ID=str(r)))
             for r in range(2)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while not os.path.exists(os.path.join(work, "stepped1")):
            assert all(p.poll() is None for p in procs), [p.returncode for p in procs]
            assert time.monotonic() < deadline, "rank 1 took no step in time"
            time.sleep(0.05)
        procs[1].send_signal(signal.SIGTERM)
        open(os.path.join(work, "sent"), "w").close()
        rcs = [p.wait(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert rcs == [0, 0]
    steps = [int(open(os.path.join(work, f"done{r}")).read()) for r in range(2)]
    assert steps[0] == steps[1] == 1
    exp = os.path.join(work, "exp")
    assert sorted(f for f in os.listdir(exp) if f.startswith("ckpt")) == ["ckpt_latest.pt"]
    saved = torch.load(os.path.join(exp, "ckpt_latest.pt"), weights_only=False)
    assert saved["step"] == steps[0]


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), sys.argv[2])
