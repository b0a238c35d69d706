"""The port's training and weight tools (`rvc_maker_tpu_torch/tools/`) on
the CPU, narrow, against the JAX package's tools where those have a
counterpart (`tools/*.py`, imported by path).

The CLI runs of e2e_train and train_ab_overlay (tests/test_torch_tools_e2e.py,
tests/test_torch_tools_ab.py) call this file as their command-line
prefix: run as __main__ it narrows `config.preset` (the
tiny 6.4 kHz model of test_torch_train_pipeline.py), HuBERT (2 layers)
and the discriminator (width / 16), paces each train step to 0.25 s (so
that a SIGTERM sent after epoch N lands mid-run) and calls the port's
`cli.main`.  JAX is imported inside the tests only, so that process
imports none.
"""

import functools
import importlib.util
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from torch_port_util import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR, HOP, SEG = 6400, 64, 8
_MODEL = dict(
    spec_channels=129, segment_size=SEG, inter_channels=32, hidden_channels=32,
    filter_channels=64, n_heads=2, n_layers=1, kernel_size=3,
    resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
    upsample_rates=(4, 4, 2, 2), upsample_initial_channel=32,
    upsample_kernel_sizes=(8, 8, 4, 4), spk_embed_dim=4, gin_channels=16, sr=SR,
    use_f0=True, text_enc_hidden_dim=768)
_DATA = dict(sample_rate=SR, filter_length=256, hop_length=HOP, win_length=256,
             n_mel_channels=32)
STEP_S = 0.25
NARROW_CLI = [sys.executable, "-u", os.path.abspath(__file__)]


def narrow_cfg(vocoder="Default", pitch_guidance=True):
    from rvc_maker_tpu_torch import config as tconfig

    return tconfig.RVCConfig(
        version="v2", train=tconfig.TrainConfig(segment_size=SEG * HOP),
        data=tconfig.DataConfig(**_DATA),
        model=tconfig.ModelConfig(**dict(_MODEL, vocoder=vocoder, use_f0=pitch_guidance)))


def narrow_cli_main(argv) -> int:
    """The port's CLI at the narrow size (the module docstring)."""
    torch.set_num_threads(2)
    # TensorBoard's writer without TensorFlow, as on the card's machine
    # (importing it costs ~12 s here)
    sys.modules.setdefault("tensorflow", None)
    sys.path.insert(0, REPO)
    from rvc_maker_tpu_torch import cli
    from rvc_maker_tpu_torch import config as cfg_mod
    from rvc_maker_tpu_torch.interop import from_jax
    from rvc_maker_tpu_torch.pipelines import train as train_mod
    from rvc_maker_tpu_torch.pipelines import train_loop

    cfg_mod.preset = lambda version="v2", sample_rate=SR, *, vocoder="Default", \
        pitch_guidance=True: narrow_cfg(vocoder, pitch_guidance)
    from_jax.random_hubert_tree = functools.partial(from_jax.random_hubert_tree, n_layers=2)
    train_loop.train = functools.partial(train_loop.train, disc_width_div=16)
    make_step = train_mod.make_sharded_train_step

    def paced(*a, **kw):
        step = make_step(*a, **kw)

        def run(state, batch):
            t0 = time.perf_counter()
            out = step(state, batch)
            time.sleep(max(0.0, STEP_S - (time.perf_counter() - t0)))
            return out
        return run

    train_mod.make_sharded_train_step = paced
    return cli.main(argv)


def _load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def narrow_tools(monkeypatch):
    from rvc_maker_tpu_torch.interop import from_jax
    from rvc_maker_tpu_torch.tools import e2e_train, train_ab_overlay

    monkeypatch.setattr(e2e_train, "CLI", NARROW_CLI)
    monkeypatch.setattr(e2e_train, "SR", SR)
    monkeypatch.setattr(train_ab_overlay, "SR", SR)
    monkeypatch.setattr(from_jax, "random_hubert_tree",
                        functools.partial(from_jax.random_hubert_tree, n_layers=2))
    return e2e_train, train_ab_overlay


def test_tools_keep_the_jax_tools_commands_and_defaults():
    from rvc_maker_tpu_torch.tools import e2e_train, train_ab_overlay

    run = e2e_train.build_parser().parse_args(["run"])
    assert (run.files, run.epochs, run.batch_size, run.kill_epoch, run.save_every,
            run.cpu) == (60, 120, 32, 60, 25, False)
    assert e2e_train.build_parser().parse_args(["gen"]).files == 60
    ab = train_ab_overlay.build_parser().parse_args([])
    assert (ab.files, ab.epochs, ab.batch_size, ab.env, ab.cpu) == (
        6, 8, 4, "RVC_TPU_BF16_SPEC=1", False)
    assert train_ab_overlay.SR == 32000 and e2e_train.SR == 48000


def test_gen_dataset_is_the_jax_tools_corpus(tmp_path):
    from rvc_maker_tpu_torch.tools import e2e_train

    jtool = _load_jax_tool("e2e_train_tpu")
    e2e_train.gen_dataset(str(tmp_path / "port"), 2, seconds=1.0, seed=3)
    jtool.gen_dataset(str(tmp_path / "jax"), 2, seconds=1.0, seed=3)
    names = sorted(os.listdir(tmp_path / "jax" / "0"))
    assert names == ["s000.wav", "s001.wav"] == sorted(os.listdir(tmp_path / "port" / "0"))
    for f in names:
        assert (tmp_path / "port" / "0" / f).read_bytes() == \
            (tmp_path / "jax" / "0" / f).read_bytes()


def test_int8_gate_metrics_follow_the_jax_formula():
    """gate_metrics against JAX's formula (tools/int8_gate_rehearsal.py)
    with JAX's mel_spectrogram, on two seeded waveforms."""
    import jax.numpy as jnp

    from rvc_maker_tpu.ops.stft import mel_spectrogram as jmel
    from rvc_maker_tpu_torch.tools import int8_gate_rehearsal as gate

    sr = 32000
    rs = np.random.RandomState(8)
    t = np.arange(int(1.5 * sr)) / sr
    ref = (0.4 * np.sin(2 * np.pi * 220 * t) + 0.05 * rs.randn(len(t))).astype(np.float32)
    got = (ref + 0.02 * rs.randn(len(t))).astype(np.float32)

    def jlog_mel(w):
        return np.asarray(jmel(jnp.asarray(w[None], jnp.float32), n_fft=1024, num_mels=80,
                               sample_rate=sr, hop_length=256, win_length=1024, fmin=0.0,
                               fmax=None)[0])

    np.testing.assert_allclose(gate.log_mel(ref, sr), jlog_mel(ref), atol=1e-3)
    n = min(len(ref), len(got))
    mel_ref, mel_got = jlog_mel(ref), jlog_mel(got[:n])
    m = min(mel_ref.shape[-1], mel_got.shape[-1])
    mel_l1 = float(np.mean(np.abs(mel_ref[..., :m] - mel_got[..., :m])))
    err = ref[:n] - got[:n]
    snr = float(10 * np.log10(np.mean(ref[:n] ** 2) / max(np.mean(err ** 2), 1e-12)))
    r = gate.gate_metrics(ref, got, sr)
    assert abs(r["mel_l1"] - mel_l1) <= 1e-3 * abs(mel_l1)
    assert abs(r["snr_db"] - snr) <= 1e-3 * abs(snr)
    assert r["passes_gate"] == (mel_l1 < 1.0)
    assert set(r) == {"mel_l1", "mel_max", "snr_db", "passes_gate"}
    # a shorter waveform: the common frames and samples (JAX's formula cuts
    # the mel axis there and cannot subtract)
    short = gate.gate_metrics(ref, got[:-1000], sr)
    mel_short = jlog_mel(got[:-1000])
    want = float(np.mean(np.abs(mel_ref[: len(mel_short)] - mel_short)))
    assert abs(short["mel_l1"] - want) <= 1e-3 * want


# ---------------------------------------------------------------------------
# the validator on stand-ins written by the port's own writers
# ---------------------------------------------------------------------------

def _standins(d):
    """Stand-ins for the artifact classes the port writes: an interchange
    .pth (a 16 kHz synthesizer at the v2 embedding width) and its voice
    .onnx (dynamic frame axis), a fairseq HuBERT .pt (2 layers), rmvpe.pt (narrow), a Whisper .pt (tiny dims),
    an HTDemucs .th (narrow), a faiss .index with its total_fea.npy, and a
    4-D-input .onnx (an MDX-shaped conv graph)."""
    from rvc_maker_tpu_torch import config as tconfig
    from rvc_maker_tpu_torch.interop import demucs_load, from_jax, onnx_proto
    from rvc_maker_tpu_torch.interop.onnx_export import export_onnx
    from rvc_maker_tpu_torch.interop.onnx_voice import export_voice_model
    from rvc_maker_tpu_torch.interop.pth import export_synthesizer_pth
    from rvc_maker_tpu_torch.models.demucs import DemucsConfig
    from rvc_maker_tpu_torch.models.whisper import WhisperDims
    from rvc_maker_tpu_torch.retrieval.ivf import build_ivf_file

    mcfg = tconfig.ModelConfig(**dict(_MODEL, sr=16000, upsample_rates=(5, 4, 2, 2, 2),
                                      upsample_kernel_sizes=(10, 8, 4, 4, 4)))
    tree = from_jax.random_synthesizer_tree(mcfg, seed=3)
    export_synthesizer_pth(from_jax.synthesizer_from_jax(tree, mcfg),
                           tconfig.RVCConfig(version="v2", model=mcfg),
                           str(d / "standin_voice.pth"), epoch=1, step=1, author="t")
    export_voice_model(str(d / "standin_voice.pth"), str(d / "standin_voice.onnx"))
    torch.save({"model": from_jax.hubert_state_dict(from_jax.random_hubert_tree(
        seed=1, n_layers=2))}, str(d / "hubert_base.pt"))
    torch.save(from_jax.rmvpe_state_dict(from_jax.random_rmvpe_tree(
        seed=2, widths=(4, 8, 16, 32, 64), inter_width=128), np.random.RandomState(0)),
        str(d / "rmvpe.pt"))
    dims = WhisperDims(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
                       n_audio_layer=1, n_vocab=51865, n_text_ctx=448, n_text_state=64,
                       n_text_head=2, n_text_layer=1)
    from_jax.write_whisper_pt(str(d / "whisper_tiny.pt"),
                              from_jax.random_whisper_tree(dims, seed=4), dims)
    dcfg = DemucsConfig(segment=0.3)
    sd = from_jax.random_demucs_state_dict(dcfg, channels=8, t_layers=1, seed=5)
    demucs_load.install_demucs_shims()
    torch.save({"klass": demucs_load.marker_class("demucs", "htdemucs", "HTDemucs"),
                "args": (), "kwargs": dict(sources=list(dcfg.sources), audio_channels=2,
                                           channels=8, nfft=4096, depth=4, t_layers=1,
                                           segment=0.3, samplerate=44100),
                "state": sd}, str(d / "htdemucs_standin.th"))
    fea = np.random.RandomState(6).randn(300, 768).astype(np.float32)
    np.save(str(d / "total_fea.npy"), fea)
    build_ivf_file(fea, str(d / "added_standin_v2.index"), device="cpu")

    class Mdx(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(4, 4, 3, padding=1)

        def forward(self, x):
            return self.conv(x)

    onnx_proto.save_model(export_onnx(Mdx().eval(), (torch.zeros(1, 4, 16, 8),),
                                      input_names=["input"], output_names=["output"]),
                          str(d / "mdx_standin.onnx"))
    return d


@pytest.fixture(scope="module")
def standin_dir(tmp_path_factory):
    return _standins(tmp_path_factory.mktemp("standins"))


PASSES = {"synth_pth", "hubert_pt", "rmvpe_pt", "whisper_pt", "demucs", "mdx_onnx",
          "faiss_index", "voice_onnx", "bf16_gate"}
SKIPS = {"fcpe_pt", "crepe_pth", "audioldm2_dir", "f0_onnx"}


def test_validator_on_standins(standin_dir, capsys):
    from rvc_maker_tpu_torch.tools import validate_real_weights as v

    assert v.main([str(standin_dir), "--lenient", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-1])["validate_real_weights"]
    assert summary == {"checks": 13, "pass": len(PASSES), "skip": len(SKIPS), "fail": 0,
                       "lenient": True}
    status = {ln.split()[1].rstrip(":"): ln.split()[0] for ln in lines[:-1]
              if ln.split()[0] in ("PASS", "SKIP", "FAIL")}
    assert status == {**{k: "PASS" for k in PASSES}, **{k: "SKIP" for k in SKIPS}}
    assert [name for name, _ in v.CHECKS] == [
        "synth_pth", "hubert_pt", "rmvpe_pt", "fcpe_pt", "crepe_pth", "whisper_pt", "demucs",
        "mdx_onnx", "audioldm2_dir", "faiss_index", "voice_onnx", "f0_onnx", "bf16_gate"]
    # --only, and a FAIL's exit code
    assert v.main([str(standin_dir), "--lenient", "--device", "cpu",
                   "--only", "faiss_index"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "validate_real_weights"]["checks"] == 1
    np.save(str(standin_dir / "sub_total_fea.npy"), np.zeros((2, 768), np.float32))
    try:
        out = v.validate(str(standin_dir), lenient=True, device="cpu", only=["faiss_index"])
    finally:
        os.remove(str(standin_dir / "sub_total_fea.npy"))
    assert out["summary"]["fail"] == 0   # total_fea.npy is found first, sorted by path


def test_validator_checks_agree_with_jax(standin_dir, monkeypatch):
    """synth_pth, faiss_index and bf16_gate of the port against JAX's check
    functions on the same directory: the structural fields equal, bf16_gate
    passing in both with the port's mel_l1 within 0.40 of JAX's."""
    from rvc_maker_tpu.models import hubert as jhubert
    from rvc_maker_tpu_torch.tools import validate_real_weights as v

    monkeypatch.setattr(jhubert, "N_LAYERS", 2)
    jtool = _load_jax_tool("validate_real_weights")
    monkeypatch.setattr(jtool.Ctx, "ref_available", lambda self: False)
    jctx = jtool.Ctx(type("A", (), dict(dir=str(standin_dir), lenient=True, audio=""))())
    pctx = v.Ctx(str(standin_dir), lenient=True, device="cpu")
    synth_j, synth_p = jtool.check_synth_pth(jctx), v.check_synth_pth(pctx)
    assert synth_p == synth_j
    assert v.check_faiss(pctx) == jtool.check_faiss(jctx)
    gate_j, gate_p = jtool.check_bf16(jctx), v.check_bf16(pctx)
    assert gate_j["mel_l1"] < 1.0 and gate_p["mel_l1"] < 1.0
    assert abs(gate_p["mel_l1"] - gate_j["mel_l1"]) <= 0.40, (gate_p, gate_j)


if __name__ == "__main__":
    sys.exit(narrow_cli_main(sys.argv[1:]))
