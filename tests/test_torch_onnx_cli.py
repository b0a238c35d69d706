"""The CLI's ONNX flow: `cli export-onnx` writes a `.onnx` voice model that
the JAX package's loader takes, then `cli convert --device cpu` converts
with it, a `.onnx` embedder and an `--f0-onnx` RMVPE graph, against the
port's pipeline on the `.pth` and `.pt` they were exported from and the
same RMVPE graph: within 1e-3 plus one int16 step.  The narrow model is
test_torch_convert_f0.py's."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from rvc_maker_tpu.config import model_config_to_ckpt_list
from rvc_maker_tpu.interop.onnx_voice import OnnxVoiceModel as JaxVoiceModel
from rvc_maker_tpu.interop.torch_export import synthesizer_state_dict
from rvc_maker_tpu_torch import cli
from rvc_maker_tpu_torch.config import ModelConfig
from rvc_maker_tpu_torch.interop import from_jax
from rvc_maker_tpu_torch.interop.onnx_embedder import export_embedder
from rvc_maker_tpu_torch.interop.onnx_export import export_onnx
from rvc_maker_tpu_torch.interop.onnx_run import OnnxGraph
from rvc_maker_tpu_torch.interop.pth import load_synthesizer_pth
from rvc_maker_tpu_torch.models.hubert import load_hubert_pt
from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline, ConvertSettings
from rvc_maker_tpu_torch.utils.audio import load_audio, read_wav, save_wav
from test_torch_convert_f0 import JCFG
from torch_port_util import hubert_state_dict, torch_threads, voice  # noqa: F401

CFG = ModelConfig(**dataclasses.asdict(JCFG))
INT16_STEP = 1.0 / 32768


def _rmvpe_stub():
    """A salience graph with RMVPE's I/O: mel (B, 128, 32t) -> (B, 32t,
    360), peaked where the mel's energy is."""
    rs = np.random.RandomState(3)
    p = {"w": torch.as_tensor(rs.randn(128, 360).astype(np.float32) * 0.3),
         "b": torch.as_tensor(rs.randn(360).astype(np.float32))}
    return export_onnx(lambda p, mel: torch.sigmoid(mel.transpose(1, 2) @ p["w"] + p["b"]),
                       (torch.zeros(1, 128, 64),), params=p, input_names=["mel"],
                       output_names=["hidden"], dynamic_axes={"mel": {2: "32*t"}})


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from rvc_maker_tpu_torch.interop import onnx_proto

    d = tmp_path_factory.mktemp("onnx_cli")
    synth = from_jax.random_synthesizer_tree(CFG, seed=0)
    for u in synth["dec"]["ups"]:       # a loud decode: 1e-3 is a tight bound
        u["w"] *= 20.0
    synth["dec"]["conv_post"]["w"] *= 20.0
    sd = synthesizer_state_dict(synth, JCFG)
    torch.save({"weight": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                "config": model_config_to_ckpt_list(JCFG), "f0": 1, "version": "v2"},
               d / "voice.pth")
    torch.save({"model": hubert_state_dict(from_jax.random_hubert_tree(seed=1, n_layers=2))},
               d / "hubert.pt")
    export_embedder(load_hubert_pt(str(d / "hubert.pt")), str(d / "hubert.onnx"))
    onnx_proto.save_model(_rmvpe_stub(), str(d / "rmvpe.onnx"))
    save_wav(str(d / "in.wav"), voice(1.5, 210.0, 6), 16000)
    assert cli.main(["export-onnx", "--model", str(d / "voice.pth"),
                     "--output", str(d / "voice.onnx")]) == 0
    return d


def test_export_onnx_file_loads_in_jax(files):
    vm = JaxVoiceModel(str(files / "voice.onnx"))
    assert vm.dynamic and vm.cfg.inter_channels == CFG.inter_channels and vm.cfg.upp == CFG.upp


def test_cli_convert_with_onnx_files(files):
    d = files
    assert cli.main(["convert", "--input", str(d / "in.wav"), "--output", str(d / "out.wav"),
                     "--model", str(d / "voice.onnx"), "--embedder-path", str(d / "hubert.onnx"),
                     "--f0-method", "rmvpe", "--f0-onnx", "--rmvpe-path", str(d / "rmvpe.onnx"),
                     "--index-rate", "0", "--device", "cpu"]) == 0
    got, sr = read_wav(str(d / "out.wav"))
    params, cfg, _ = load_synthesizer_pth(str(d / "voice.pth"))
    pipe = ConvertPipeline(params, cfg, load_hubert_pt(str(d / "hubert.pt")), version="v2",
                           rmvpe_params=OnnxGraph(str(d / "rmvpe.onnx"), device="cpu"),
                           device="cpu")
    ref = pipe.convert_utterance(load_audio(str(d / "in.wav"), 16000), 0,
                                 ConvertSettings(f0_method="rmvpe", index_rate=0.0))
    assert sr == cfg.sr and got.shape == ref.shape and np.abs(ref).max() > 0.1
    err = float(np.abs(got - np.clip(ref, -1.0, 1.0)).max())
    assert err <= 1e-3 + INT16_STEP, err


def test_cli_convert_f0_onnx_bootstraps_the_predictor(files, tmp_path, monkeypatch):
    """--f0-onnx without --rmvpe-path: the port asks its bootstrap for the
    URL and path JAX's bootstrap gives `rmvpe-onnx` (the download mocked
    to copy the stub graph), then converts as with --rmvpe-path."""
    import shutil

    from rvc_maker_tpu.utils import bootstrap as jboot
    from rvc_maker_tpu_torch.utils import bootstrap

    d = files
    asked = []

    def fake(url, path):
        asked.append((url, path))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        shutil.copy(d / "rmvpe.onnx", path)
        return path

    monkeypatch.setattr(bootstrap, "ASSETS", str(tmp_path / "assets"))
    monkeypatch.setattr("rvc_maker_tpu_torch.utils.downloads.download_url", fake)
    flags = ["--input", str(d / "in.wav"), "--model", str(d / "voice.onnx"), "--embedder-path",
             str(d / "hubert.onnx"), "--f0-method", "rmvpe", "--f0-onnx", "--index-rate", "0",
             "--device", "cpu"]
    assert cli.main(["convert", *flags, "--output", str(tmp_path / "boot.wav")]) == 0
    assert cli.main(["convert", *flags, "--output", str(tmp_path / "given.wav"),
                     "--rmvpe-path", str(d / "rmvpe.onnx")]) == 0
    assert len(asked) == 1                            # the second run found the file there
    monkeypatch.setattr(jboot, "ASSETS", str(tmp_path / "assets"))
    jax_asked = []
    monkeypatch.setattr("rvc_maker_tpu.utils.downloads.download_url",
                        lambda url, path: jax_asked.append((url, path)) or path)
    os.remove(asked[0][1])
    jboot.ensure_predictor("rmvpe-onnx")
    assert asked == jax_asked
    assert asked[0][0] == f"{bootstrap.HF_BASE}predictors/rmvpe.onnx"
    np.testing.assert_array_equal(read_wav(str(tmp_path / "boot.wav"))[0],
                                  read_wav(str(tmp_path / "given.wav"))[0])
