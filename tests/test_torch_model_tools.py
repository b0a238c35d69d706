"""The port's model tools (`rvc_maker_tpu_torch/utils/model_tools.py`,
`cli fuse`, `cli info`) against the JAX package's on `.pth` files the
JAX exporter writes: the fused checkpoint and `model_info` equal to
JAX's, and the fused `.pth` loading in the port's `load_synthesizer_pth`
and converting, on the CPU, within 1e-3 plus one int16 step of the JAX
package's conversion of the same file."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from rvc_maker_tpu import cli as jcli
from rvc_maker_tpu.models import hubert as jhubert
from rvc_maker_tpu.utils import model_tools as jtools
from rvc_maker_tpu_torch import cli
from rvc_maker_tpu_torch.interop.pth import load_synthesizer_pth
from rvc_maker_tpu_torch.utils import model_tools as tools
from rvc_maker_tpu_torch.utils.audio import read_wav, save_wav
from test_torch_convert_flags import JCFG
from torch_port_util import patch_jax_noise, torch_threads, voice, write_voice_files  # noqa: F401

ATOL = 1e-3 + 1.0 / 32768


@pytest.fixture(scope="module")
def voices(tmp_path_factory):
    """Voice A with 3 speakers and voice B with 4 (fusion blends the
    speaker table over its common rows), and the converter's files."""
    d = tmp_path_factory.mktemp("model_tools")
    a = write_voice_files(d, dataclasses.replace(JCFG, spk_embed_dim=3), seed=0)
    b = write_voice_files(d, JCFG, seed=7)
    save_wav(str(d / "in.wav"), voice(1.0, 200.0, 2), 16000)
    return dict(a, a=a["model"], b=b["model"], input=str(d / "in.wav"), dir=d)


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=False)


def _same_checkpoint(p, j):
    got, ref = _load(p), _load(j)
    assert set(got) == set(ref)
    assert list(got["weight"]) == list(ref["weight"])
    for k, v in ref["weight"].items():
        assert got["weight"][k].dtype == v.dtype == torch.float16
        assert torch.equal(got["weight"][k], v), k
    for k in set(ref) - {"weight", "creation_date"}:
        assert got[k] == ref[k], k
    return got


@pytest.mark.parametrize("ratio", [0.5, 0.3])
def test_fuse_matches_jax(voices, tmp_path, ratio):
    tools.fuse_models(voices["a"], voices["b"], str(tmp_path / "p.pth"), ratio=ratio)
    jtools.fuse_models(voices["a"], voices["b"], str(tmp_path / "j.pth"), ratio=ratio)
    got = _same_checkpoint(tmp_path / "p.pth", tmp_path / "j.pth")
    assert got["weight"]["emb_g.weight"].shape[0] == 3
    assert got["model_hash"] == tools.model_hash_of_state_dict(got["weight"])


def test_fuse_refuses_what_jax_refuses(voices, tmp_path):
    ckpt = _load(voices["b"])
    ckpt["sr"] = 40000
    torch.save(ckpt, tmp_path / "sr.pth")
    with pytest.raises(ValueError, match="sample rates differ"):
        tools.fuse_models(voices["a"], str(tmp_path / "sr.pth"), str(tmp_path / "x.pth"))
    ckpt = _load(voices["b"])
    ckpt["weight"].pop("dec.conv_post.weight")
    torch.save(ckpt, tmp_path / "keys.pth")
    with pytest.raises(ValueError, match="architectures differ"):
        tools.fuse_models(voices["a"], str(tmp_path / "keys.pth"), str(tmp_path / "x.pth"))


def test_model_info_matches_jax(voices, tmp_path):
    tools.fuse_models(voices["a"], voices["b"], str(tmp_path / "f.pth"))
    for path in (voices["a"], voices["b"], str(tmp_path / "f.pth")):
        info = tools.model_info(path)
        assert info == jtools.model_info(path)
        assert info["sr"] == JCFG.sr and info["n_parameters"] > 0
    assert tools.model_info(voices["b"])["n_speakers"] == 4


def test_cli_fuse_and_info_match_jax(voices, tmp_path, capsys):
    for main, out in ((cli.main, "p.pth"), (jcli.main, "j.pth")):
        main(["fuse", "--model-a", voices["a"], "--model-b", voices["b"],
              "--output", str(tmp_path / out), "--ratio", "0.25"])
    _same_checkpoint(tmp_path / "p.pth", tmp_path / "j.pth")
    capsys.readouterr()
    assert cli.main(["info", "--model", str(tmp_path / "p.pth")]) == 0
    got = json.loads(capsys.readouterr().out)
    jcli.main(["info", "--model", str(tmp_path / "p.pth")])
    assert got == json.loads(capsys.readouterr().out)
    assert got["infos"] == "fused voice0.pth + voice7.pth @ 0.25"


def test_fused_pth_converts_as_in_jax(voices, tmp_path, monkeypatch):
    """The fused .pth loads in the port and `cli convert --device cpu`
    on it writes what JAX's `cli convert` writes."""
    fused = str(tmp_path / "fused.pth")
    tools.fuse_models(voices["a"], voices["b"], fused, ratio=0.6)
    params, cfg, meta = load_synthesizer_pth(fused)
    assert cfg.spk_embed_dim == 3 and meta["version"] == "v2"
    assert params["emb_g"]["w"].shape[0] == 3
    monkeypatch.setattr(jhubert, "N_LAYERS", 2)
    patch_jax_noise(monkeypatch)
    argv = ["convert", "--input", voices["input"], "--model", fused, "--sid", "2",
            "--rmvpe-path", voices["rmvpe"], "--embedder-path", voices["embedder"]]
    assert cli.main([*argv, "--output", str(tmp_path / "p.wav"), "--device", "cpu"]) == 0
    jcli.main([*argv, "--output", str(tmp_path / "j.wav")])
    got, sr = read_wav(str(tmp_path / "p.wav"))
    ref, jsr = read_wav(str(tmp_path / "j.wav"))
    assert sr == jsr == JCFG.sr and got.shape == ref.shape and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
