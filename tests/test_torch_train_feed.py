"""The training loop's resume digest and bf16 spectrogram feed
(`pipelines/train_loop.py`, `pipelines/train.py`), on the CPU at the
tiny configs of tests/test_torch_train*.py.

state_params_hash: equal for equal params, moved by a one-ulp change of
one leaf, equal on a state restored by load_checkpoint and in
`tools.e2e_train.ckpt_hash_offprocess` of the saved file; a resume logs
JAX's `resume params_g sha256=<hex> step=<n>` line under
RVC_TPU_RESUME_HASH only.  RVC_TPU_BF16_SPEC=1 feeds a bf16 run's spec in
bf16 (bitwise spec.to(bfloat16)); with the switch unset every step is
bitwise what it was when the mel target took batch.spec as it came.  The
bf16 step on a bf16 spec against JAX's: tests/test_torch_train_feed_jax.py
(its JAX bf16 compile alone takes ~45 s).
"""

import dataclasses
import logging
import os

import numpy as np
import pytest
import torch

from rvc_maker_tpu_torch.pipelines import train as ttrain
from rvc_maker_tpu_torch.pipelines import train_loop as tloop
from rvc_maker_tpu_torch.tools import e2e_train
from test_torch_train import DIV, _batch_np
from test_torch_train_sigterm import _cfg as loop_cfg
from test_torch_train_sigterm import _write_exp
from test_torch_train_vocoders import configs
from torch_port_util import torch_threads  # noqa: F401

RESUME = "resume params_g sha256={} step={}"
_MAKE_STEP = ttrain.make_sharded_train_step


def _state(seed=1):
    return ttrain.init_state(loop_cfg(), device="cpu", disc_width_div=16, seed=seed)


def test_state_params_hash_certifies_the_restore(tmp_path):
    a, b = _state(), _state()
    assert tloop.state_params_hash(a) == tloop.state_params_hash(b)
    assert tloop.state_params_hash(a) != tloop.state_params_hash(_state(seed=2))
    leaf = ttrain.tree_leaves(b.params_g)[3]
    with torch.no_grad():
        flat = leaf.view(-1)
        flat[0] = torch.nextafter(flat[0], torch.tensor(np.inf))
    assert tloop.state_params_hash(a) != tloop.state_params_hash(b)

    a.step = 7
    tloop.save_checkpoint(a, str(tmp_path / tloop.LATEST), epoch=3)
    restored = _state(seed=5)
    assert tloop.state_params_hash(restored) != tloop.state_params_hash(a)
    assert tloop.load_checkpoint(str(tmp_path / tloop.LATEST), restored) == 3
    digest = tloop.state_params_hash(restored)
    assert digest == tloop.state_params_hash(a) and len(digest) == 64
    assert e2e_train.ckpt_hash_offprocess(str(tmp_path)) == (digest, 7)


@pytest.mark.parametrize("env", [True, False], ids=["hash", "no_hash"])
def test_resume_logs_the_jax_hash_line(tmp_path, monkeypatch, caplog, env):
    exp = str(tmp_path / "exp")
    _write_exp(exp)
    run = dict(batch_size=4, save_every_epoch=1, overtraining_detector=False,
               log_writer=lambda *a: None, device="cpu", disc_width_div=16)
    if env:
        monkeypatch.setenv("RVC_TPU_RESUME_HASH", "1")
    else:
        monkeypatch.delenv("RVC_TPU_RESUME_HASH", raising=False)
    first = tloop.train(exp, loop_cfg(), total_epochs=1, **run)
    line = RESUME.format(tloop.state_params_hash(first), first.step)
    with caplog.at_level(logging.INFO, logger=tloop.logger.name):
        tloop.train(exp, loop_cfg(), total_epochs=1, **run)
    resumed = [r.getMessage() for r in caplog.records if "resume params_g" in r.getMessage()]
    assert resumed == ([line] if env else [])
    assert e2e_train.RESUME_LINE.findall(line) == [(tloop.state_params_hash(first),
                                                   str(first.step))]


def _fed_specs(exp, monkeypatch, *, bf16, switch):
    """The spec of every batch train() feeds its step (one epoch)."""
    specs = []
    make = _MAKE_STEP

    def recording(*a, **kw):
        step = make(*a, **kw)

        def run(state, batch):
            specs.append(batch.spec.clone())
            return step(state, batch)
        return run

    monkeypatch.setattr(ttrain, "make_sharded_train_step", recording)
    if switch is None:
        monkeypatch.delenv("RVC_TPU_BF16_SPEC", raising=False)
    else:
        monkeypatch.setenv("RVC_TPU_BF16_SPEC", switch)
    cfg = loop_cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, bf16=bf16))
    tloop.train(exp, cfg, total_epochs=1, batch_size=4, save_every_epoch=1,
                overtraining_detector=False, log_writer=lambda *a: None, device="cpu",
                disc_width_div=16)
    for f in os.listdir(exp):
        if f.startswith("ckpt_") or f.endswith(".pth"):
            os.remove(os.path.join(exp, f))
    return specs


def test_bf16_spec_switch_feeds_the_spec_in_bf16(tmp_path, monkeypatch):
    exp = str(tmp_path / "exp")
    _write_exp(exp)
    base = _fed_specs(exp, monkeypatch, bf16=True, switch=None)
    fed = _fed_specs(exp, monkeypatch, bf16=True, switch="1")
    off = _fed_specs(exp, monkeypatch, bf16=True, switch="0")
    fp32_run = _fed_specs(exp, monkeypatch, bf16=False, switch="1")
    assert len(base) == len(fed) == len(off) == len(fp32_run) == 2
    for b, f, o, p in zip(base, fed, off, fp32_run):
        assert b.dtype == o.dtype == p.dtype == torch.float32
        assert f.dtype == torch.bfloat16
        assert torch.equal(f.view(torch.int16), b.to(torch.bfloat16).view(torch.int16))
        assert torch.equal(o, b) and torch.equal(p, b)

    batch = ttrain.Batch(**_batch_np(seed=3))
    got = batch.to("cpu", torch.bfloat16, half_spec=True)
    want = torch.as_tensor(batch.spec).to(torch.bfloat16)
    assert torch.equal(got.spec.view(torch.int16), want.view(torch.int16))
    plain = batch.to("cpu", torch.bfloat16)
    assert plain.spec.dtype == torch.float32
    assert torch.equal(plain.spec, torch.as_tensor(batch.spec))
    # without a half dtype the switch has nothing to cast to
    assert batch.to("cpu", None, half_spec=True).spec.dtype == torch.float32


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_steps_without_the_switch_are_unchanged(monkeypatch, bf16):
    """The mel target takes batch.spec.float(): with an fp32 spec that is
    batch.spec itself, so each step is bitwise the step that took
    batch.spec as it came (run here by handing spec_to_mel the batch's
    own tensor)."""
    _, pcfg = configs("nsf")
    pcfg = dataclasses.replace(pcfg, train=dataclasses.replace(pcfg.train, bf16=bf16))
    half = torch.bfloat16 if bf16 else None
    b = _batch_np(seed=11)
    seen = []
    spec_to_mel = ttrain.spec_to_mel

    def run(as_it_came):
        batch = ttrain.Batch(**b).to("cpu", half)
        assert batch.spec.dtype == torch.float32

        def mel(spec, **kw):
            seen.append(spec is batch.spec)
            return spec_to_mel(batch.spec if as_it_came else spec, **kw)
        monkeypatch.setattr(ttrain, "spec_to_mel", mel)
        state = ttrain.init_state(pcfg, device="cpu", disc_width_div=DIV, seed=4)
        m = ttrain.make_train_step(pcfg, DIV)(state, batch, keep_grads=True)
        return state, m

    s1, m1 = run(False)
    s2, m2 = run(True)
    assert seen == [True, True]
    for k in ("loss_g", "loss_d", "loss_mel", "loss_kl", "loss_fm", "loss_adv"):
        assert torch.equal(m1[k], m2[k]), k
    for a, r in zip(m1["grads_g"] + ttrain.tree_leaves(s1.params_g),
                    m2["grads_g"] + ttrain.tree_leaves(s2.params_g)):
        assert torch.equal(a, r)
