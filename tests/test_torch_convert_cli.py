"""The port's loaders and CLI on this slice's files: a transformers
HuBERT directory against the JAX loader (tree exact, features <= 1e-4),
`cli convert --device cpu` with the new F0 flags against the pipeline on
the same files, and the CLI's missing-weight and --f0-onnx errors.  The narrow
model is test_torch_convert_f0.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu.config import model_config_to_ckpt_list
from rvc_maker_tpu.interop.torch_export import synthesizer_state_dict
from rvc_maker_tpu.models import hubert as jhubert
from rvc_maker_tpu_torch import cli
from rvc_maker_tpu_torch.interop import from_jax
from rvc_maker_tpu_torch.interop.pth import load_synthesizer_pth
from rvc_maker_tpu_torch.models import crepe as tcrepe
from rvc_maker_tpu_torch.models import fcpe as tfcpe
from rvc_maker_tpu_torch.models import hubert as thubert
from rvc_maker_tpu_torch.models import rmvpe as trmvpe
from rvc_maker_tpu_torch.pipelines.convert import (ConvertPipeline, ConvertSettings,
                                                   convert_split)
from rvc_maker_tpu_torch.utils.audio import load_audio, read_wav, save_wav
from test_torch_convert_f0 import JCFG, trees  # noqa: F401
from torch_port_util import (crepe_state_dict, fcpe_state_dict, hf_hubert_state_dict,
                             hubert_state_dict, n, rmvpe_state_dict, torch_threads,  # noqa: F401
                             voice)


@pytest.mark.parametrize("fmt", ["pytorch_model.bin", "model.safetensors"])
def test_transformers_hubert_matches_jax(trees, tmp_path, monkeypatch, fmt):
    """A transformers HubertModel checkpoint ("hubert."-prefixed keys, a
    final_proj head) in a directory loads to the tree the JAX loader
    gives (its layer count patched to the test's 2), and its features
    match JAX's <= 1e-4."""
    sd = hf_hubert_state_dict(trees["hubert"])
    if fmt.endswith(".bin"):
        torch.save(sd, tmp_path / fmt)
    else:
        from safetensors.torch import save_file

        save_file({k: v.contiguous() for k, v in sd.items()}, str(tmp_path / fmt))
    monkeypatch.setattr(jhubert, "N_LAYERS", 2)
    jtree = jhubert.load_transformers_dir(str(tmp_path))
    ref = from_jax.hubert_from_jax(jax.tree_util.tree_map(np.asarray, jtree))
    got = thubert.load_transformers_dir(str(tmp_path))
    assert len(got["layers"]) == 2
    flat_g = torch.nn.utils.parameters_to_vector(_tensors(got))
    flat_r = torch.nn.utils.parameters_to_vector(_tensors(ref))
    np.testing.assert_allclose(n(flat_g), n(flat_r), rtol=1e-6, atol=1e-7)
    audio = voice(1.0, 200.0, 5)[None]
    feats_j, _ = jhubert.extract_features(jtree, jnp.asarray(audio), output_layer=2)
    with torch.inference_mode():
        feats, _ = thubert.extract_features(got, torch.as_tensor(audio), output_layer=2)
    err = float(np.abs(n(feats) - n(feats_j)).max())
    print(f"transformers HuBERT ({fmt}): features max abs err {err:.3e}")
    assert err <= 1e-4, err


def _tensors(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tensors(v)]
    return [tree.reshape(-1)]


@pytest.fixture(scope="module")
def weight_files(trees, tmp_path_factory):
    d = tmp_path_factory.mktemp("weights")
    sd = synthesizer_state_dict(trees["synth"], JCFG)
    torch.save({"weight": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                "config": model_config_to_ckpt_list(JCFG), "f0": 1, "version": "v2"},
               d / "voice.pth")
    torch.save(rmvpe_state_dict(trees["rmvpe"], np.random.RandomState(0)), d / "rmvpe.pt")
    torch.save({"model": hubert_state_dict(trees["hubert"])}, d / "hubert.pt")
    torch.save({"model": fcpe_state_dict(trees["fcpe"], legacy=False), "config_dict": {}},
               d / "fcpe.pt")
    torch.save(crepe_state_dict(trees["crepe"], np.random.RandomState(1)), d / "crepe_tiny.pth")
    (d / "f0.txt").write_text("0.0,150.0\n0.2,220.0\n0.4,180.0\n")
    save_wav(str(d / "in.wav"), voice(1.5, 210.0, 6), 16000)
    return d


CLI_CASES = {
    "fcpe": (["--f0-method", "fcpe", "--fcpe-path", "fcpe.pt"], {}),
    "crepe-tiny": (["--f0-method", "crepe-tiny", "--crepe-path", "crepe_tiny.pth"], {}),
    "harvest": (["--f0-method", "harvest", "--f0-autotune", "--resample-sr", "16000"],
                dict(f0_autotune=True, resample_sr=16000)),
    "f0-file": (["--f0-method", "pm", "--f0-file", "f0.txt", "--volume-envelope", "0.5"],
                dict(f0_file="f0.txt", volume_envelope=0.5)),
    "split-audio": (["--f0-method", "hybrid[rmvpe+pyin]", "--rmvpe-path", "rmvpe.pt",
                     "--hop-length", "128", "--split-audio"], dict(hop_length=128)),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_convert_f0_methods(weight_files, case):
    """`cli convert --device cpu` writes the waveform the pipeline gives on
    the same files (as 16-bit PCM); harvest runs without --rmvpe-path."""
    d = weight_files
    flags, extra = CLI_CASES[case]
    out = d / f"out_{case}.wav"
    rc = cli.main(["convert", "--input", str(d / "in.wav"), "--output", str(out),
                   "--model", str(d / "voice.pth"), "--hubert-path", str(d / "hubert.pt"),
                   "--device", "cpu", *[str(d / f) if f.endswith((".pt", ".pth", ".txt"))
                                        else f for f in flags]])
    assert rc == 0
    got, sr = read_wav(str(out))
    method = flags[1]
    extra = {k: (str(d / v) if k == "f0_file" else v) for k, v in extra.items()}
    params, cfg, _ = load_synthesizer_pth(str(d / "voice.pth"))
    pipe = ConvertPipeline(
        params, cfg, thubert.load_hubert_pt(str(d / "hubert.pt")), device="cpu",
        rmvpe_params=trmvpe.load_rmvpe_pt(str(d / "rmvpe.pt")) if "rmvpe" in method else None,
        fcpe_params=tfcpe.load_fcpe_ckpt(str(d / "fcpe.pt"))[0] if "fcpe" in method else None,
        crepe_params=(tcrepe.load_crepe_pth(str(d / "crepe_tiny.pth"), "tiny")
                      if "crepe" in method else None))
    settings = ConvertSettings(f0_method=method, index_rate=0.5, **extra)
    audio = load_audio(str(d / "in.wav"), 16000)
    ref = (convert_split(pipe, audio, 0, settings) if case == "split-audio"
           else pipe.convert_utterance(audio, 0, settings))
    assert sr == (16000 if case == "harvest" else cfg.sr)
    expect = (np.clip(ref, -1.0, 1.0) * 32767.0).astype(np.int16).astype(np.float32) / 32768.0
    np.testing.assert_array_equal(got, expect)
    assert np.abs(got).max() > 0


def _cli(d, *flags):
    return cli.main(["convert", "--input", str(d / "in.wav"), "--output", str(d / "x.wav"),
                     "--model", str(d / "voice.pth"), "--hubert-path", str(d / "hubert.pt"),
                     "--device", "cpu", *flags])


@pytest.mark.parametrize("flags,err,match", [
    (["--f0-method", "fcpe"], ValueError, "needs --fcpe-path"),
    (["--f0-method", "rmvpe"], ValueError, "needs --rmvpe-path"),
    (["--f0-method", "hybrid[pm+crepe-tiny]"], ValueError, "needs --crepe-path"),
    (["--f0-method", "rmvpe", "--f0-onnx"], RuntimeError,
     r"could not download \S+/predictors/rmvpe\.onnx .*place the file at \S+rmvpe\.onnx"),
    (["--f0-method", "rmvpe", "--rmvpe-path", "missing.pt"], FileNotFoundError, "--rmvpe-path"),
    (["--f0-method", "hybrid[pm+crepe-full]", "--crepe-path", "crepe_tiny.pth"], ValueError,
     "not capacity 'full'"),
], ids=["fcpe", "rmvpe", "hybrid-crepe", "onnx", "missing-file", "crepe-capacity"])
def test_cli_convert_weight_errors(weight_files, flags, err, match, monkeypatch, tmp_path):
    """Each missing or wrong weight file raises.  Under --f0-onnx an absent
    path asks the bootstrap for the `.onnx` predictor, as JAX's CLI does;
    here its download fails as it does without a network (mocked)."""
    from rvc_maker_tpu_torch.utils import bootstrap

    def offline(url, path):
        raise RuntimeError(f"no network for {url}")

    monkeypatch.setattr(bootstrap, "ASSETS", str(tmp_path / "assets"))
    monkeypatch.setattr("rvc_maker_tpu_torch.utils.downloads.download_url", offline)
    d = weight_files
    with pytest.raises(err, match=match):
        _cli(d, *[str(d / f) if f.endswith((".pt", ".pth", ".onnx")) else f for f in flags])
