"""The port's training flow on the CPU at a tiny size: preprocess ->
extract (RMVPE + HuBERT) -> train -> .pth export -> convert, each held
against the JAX package where it has a counterpart; the pretrained-G
loader; the entry points' refusal to run without a card."""

import dataclasses
import functools
import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu.config import DataConfig, ModelConfig, RVCConfig, TrainConfig
from rvc_maker_tpu.interop import torch_export as jexport
from rvc_maker_tpu.interop import torch_import as jimport
from rvc_maker_tpu.models import synthesizer as jsyn
from rvc_maker_tpu.pipelines import extract as jextract
from rvc_maker_tpu.pipelines.preprocess import preprocess_dataset as jpreprocess
from rvc_maker_tpu.retrieval.index import load_index as jload_index
from rvc_maker_tpu_torch import config as tconfig
from rvc_maker_tpu_torch.interop import from_jax
from rvc_maker_tpu_torch.interop import pth as tpth
from rvc_maker_tpu_torch.models import synthesizer as tsyn
from rvc_maker_tpu_torch.pipelines import extract as textract
from rvc_maker_tpu_torch.pipelines import train as ttrain
from rvc_maker_tpu_torch.pipelines import train_loop as tloop
from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline, ConvertSettings
from rvc_maker_tpu_torch.pipelines.preprocess import preprocess_dataset
from rvc_maker_tpu_torch.utils.audio import read_wav, save_wav
from torch_port_util import (hubert_state_dict, jax_noise, n, t, torch_threads,  # noqa: F401
                             tree_np)

# hop == prod(upsample_rates) == sr / 100, as in every real preset
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
JCFG = RVCConfig(version="v2", train=TrainConfig(segment_size=SEG * HOP),
                 data=DataConfig(**_DATA), model=ModelConfig(**_MODEL))
TCFG = tconfig.RVCConfig(version="v2",
                         train=tconfig.TrainConfig(segment_size=SEG * HOP, log_interval=1),
                         data=tconfig.DataConfig(**_DATA),
                         model=tconfig.ModelConfig(**_MODEL))
RMVPE_WIDTHS, RMVPE_INTER = (4, 8, 16, 32, 64), 128


def _dataset(root, n_files=2, seconds=2.0):
    os.makedirs(root / "0", exist_ok=True)
    rs = np.random.RandomState(0)
    for i in range(n_files):
        tt = np.arange(int(SR * seconds)) / SR
        hz = 140 + 40 * i
        audio = (0.4 * np.sin(2 * np.pi * hz * tt * (1 + 0.02 * np.sin(tt)))
                 + rs.randn(len(tt)) * 0.01).astype(np.float32)
        save_wav(str(root / "0" / f"s{i}.wav"), audio, SR)


@pytest.fixture(scope="module")
def models():
    rmvpe_tree = from_jax.random_rmvpe_tree(1, widths=RMVPE_WIDTHS, inter_width=RMVPE_INTER)
    hubert_tree = from_jax.random_hubert_tree(2, n_layers=2)
    return dict(rmvpe_jax=rmvpe_tree, hubert_jax=hubert_tree,
                rmvpe=from_jax.rmvpe_from_jax(rmvpe_tree),
                hubert=from_jax.hubert_from_jax(hubert_tree))


@pytest.fixture(scope="module")
def prepared(tmp_path_factory, models):
    """A preprocessed and extracted experiment dir, made by the port."""
    root = tmp_path_factory.mktemp("flow")
    _dataset(root / "dataset")
    exp = root / "exp"
    n_seg = preprocess_dataset(str(root / "dataset"), str(exp), SR, per=1.0,
                               num_workers=1)
    nf = textract.extract_f0(str(exp), models["rmvpe"], device="cpu")
    ne = textract.extract_embeddings(str(exp), models["hubert"], version="v2",
                                     device="cpu")
    assert n_seg == nf == ne == 4
    textract.write_mute_fixture(str(exp), TCFG, models["hubert"], "v2", device="cpu")
    textract.generate_filelist(str(exp), TCFG, "v2", seed=0)
    return root, exp


def test_preprocess_matches_jax(prepared, tmp_path):
    root, exp = prepared
    ref = tmp_path / "jax_exp"
    assert jpreprocess(str(root / "dataset"), str(ref), SR, per=1.0, num_workers=1) == 4
    for sub in ("sliced_audios", "sliced_audios_16k"):
        names = sorted(os.listdir(ref / sub))
        assert names == sorted(os.listdir(exp / sub))
        for name in names:
            a, sr_a = read_wav(str(exp / sub / name))
            b, sr_b = read_wav(str(ref / sub / name))
            assert sr_a == sr_b
            np.testing.assert_array_equal(a, b)


def test_extract_matches_jax(prepared, models, tmp_path, monkeypatch):
    """RMVPE f0 and HuBERT features of the port's extract against the JAX
    extract on the same segments: features <= 1e-4 x max(1, |ref|max),
    f0 within 0.01 Hz with the same coarse bins on >= 99% of frames (a
    salience tie between near-equal bins may round apart).  The JAX
    models run jitted, which is faster here than op by op."""
    monkeypatch.setattr(jextract.rmvpe_mod, "infer", jax.jit(jextract.rmvpe_mod.infer))
    monkeypatch.setattr(jextract.hubert_mod, "extract_features", jax.jit(
        jextract.hubert_mod.extract_features, static_argnames=("output_layer",)))
    _, exp = prepared
    ref = tmp_path / "jax_exp"
    shutil.copytree(exp / "sliced_audios_16k", ref / "sliced_audios_16k")
    jextract.extract_f0(str(ref), method="rmvpe", rmvpe_params=jax.tree_util.tree_map(
        jnp.asarray, models["rmvpe_jax"]))
    jextract.extract_embeddings(str(ref), jax.tree_util.tree_map(
        jnp.asarray, models["hubert_jax"]), version="v2")
    for name in sorted(os.listdir(ref / "f0_voiced")):
        f0, f0_ref = np.load(exp / "f0_voiced" / name), np.load(ref / "f0_voiced" / name)
        assert f0.shape == f0_ref.shape
        close = np.abs(f0 - f0_ref) <= 0.01
        assert close.mean() >= 0.99, (name, close.mean())
        same = np.load(exp / "f0" / name) == np.load(ref / "f0" / name)
        assert same.mean() >= 0.99, (name, same.mean())
    for name in sorted(os.listdir(ref / "v2_extracted")):
        a, b = np.load(exp / "v2_extracted" / name), np.load(ref / "v2_extracted" / name)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-4 * max(1.0, np.abs(b).max()), name


def test_train_resume_export_and_convert(prepared, models, tmp_path):
    """train for an epoch, resume for a second, export the .pth, load it
    into ConvertPipeline and convert 2 s of audio."""
    _, exp = prepared
    exp_run = tmp_path / "exp"
    shutil.copytree(exp, exp_run)
    with open(exp_run / "filelist.txt") as f:
        text = f.read().replace(str(exp), str(exp_run))
    with open(exp_run / "filelist.txt", "w") as f:
        f.write(text)
    logged = []
    state = tloop.train(str(exp_run), TCFG, total_epochs=1, batch_size=2,
                        save_every_epoch=1, device="cpu", disc_width_div=16,
                        log_writer=lambda step, m: logged.append((step, m)))
    steps_per_epoch = state.step
    assert steps_per_epoch >= 2 and len(logged) == steps_per_epoch
    assert all(np.isfinite(m["loss_g"]) and np.isfinite(m["loss_d"]) for _, m in logged)
    state = tloop.train(str(exp_run), TCFG, total_epochs=2, batch_size=2,
                        save_every_epoch=1, device="cpu", disc_width_div=16)
    assert state.step == 2 * steps_per_epoch
    assert state.lr == pytest.approx(TCFG.train.learning_rate * TCFG.train.lr_decay ** 2)
    pths = sorted(f for f in os.listdir(exp_run) if f.endswith(".pth"))
    assert pths == [f"exp_1e_{steps_per_epoch}s.pth", f"exp_2e_{2 * steps_per_epoch}s.pth"]
    assert os.path.isfile(exp_run / "training_data.json")

    params, cfg, meta = tpth.load_synthesizer_pth(str(exp_run / pths[-1]))
    assert meta["step"] == 2 * steps_per_epoch and cfg == TCFG.model
    pipe = ConvertPipeline(params, cfg, models["hubert"], rmvpe_params=models["rmvpe"],
                           device="cpu")
    tt = np.arange(16000 * 2) / 16000
    out = pipe.convert_utterance((0.3 * np.sin(2 * np.pi * 200 * tt)).astype(np.float32),
                                 0, ConvertSettings())
    assert np.isfinite(out).all() and abs(len(out) / SR - 2.0) < 0.5


_jax_infer = jax.jit(jsyn.infer, static_argnums=(1,))


def _infer_both(tparams, jparams, cfg_t, cfg_j):
    rs = np.random.RandomState(8)
    tlen = 40
    phone = rs.randn(1, tlen, 768).astype(np.float32)
    pitch = rs.randint(1, 256, (1, tlen))
    f0 = (rs.rand(1, tlen) * 200 + 100).astype(np.float32)
    z, s = jax_noise(1, tlen, cfg_t.inter_channels, cfg_t.upp, seed=3)
    with torch.no_grad():
        got = tsyn.infer(tparams, cfg_t, t(phone), torch.tensor([tlen]),
                         torch.as_tensor(pitch), t(f0), torch.tensor([0]), t(z), t(s))[0]
    jparams = {k: v for k, v in jparams.items() if k != "enc_q"}
    ref = _jax_infer(jax.tree_util.tree_map(jnp.asarray, jparams), cfg_j,
                     jnp.asarray(phone), jnp.asarray([tlen]), jnp.asarray(pitch),
                     jnp.asarray(f0), jnp.asarray([0]), jnp.asarray(z), jnp.asarray(s))[0]
    return n(got), n(ref)


def test_export_pth_loads_in_jax(tmp_path):
    """The port's .pth, loaded by the JAX package's loader, gives the
    port loader's infer waveform (<= 1e-4 abs: both fold the same fp16
    values); against the fp32 params before export, the fp16 storage
    moves the waveform by <= 5e-3 abs."""
    tree = from_jax.random_synthesizer_tree(TCFG.model, seed=5)
    for u in tree["dec"]["ups"]:
        u["w"] *= 10.0
    tree["dec"]["conv_post"]["w"] *= 100.0      # a waveform of a visible size
    params = from_jax.synthesizer_from_jax(tree, TCFG.model, train=True)
    path = str(tmp_path / "voice.pth")
    tpth.export_synthesizer_pth(params, TCFG, path, epoch=3, step=7, author="a")
    tparams, tcfg, meta = tpth.load_synthesizer_pth(path)
    jparams, jcfg, jmeta = jimport.load_synthesizer_pth(path)
    assert (meta["epoch"], meta["step"], meta["author"]) == (3, 7, "a")
    assert jmeta["model_hash"] == meta["model_hash"]
    assert "enc_q" not in tparams and not any(
        k.startswith("enc_q") for k in torch.load(path, weights_only=False)["weight"])
    got, ref = _infer_both(tparams, tree_np(jparams), tcfg, jcfg)
    assert np.abs(ref).max() > 0.05
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    fp32, _ = _infer_both(params, tree, TCFG.model, JCFG.model)
    np.testing.assert_allclose(got, fp32, atol=5e-3, rtol=0)
    # the same state dict as the JAX exporter writes for these weights
    ref_sd = jexport.synthesizer_state_dict(tree, JCFG.model)
    got_sd = tpth.synthesizer_state_dict(params, TCFG.model)
    assert list(got_sd) == list(ref_sd)
    for k in ref_sd:
        np.testing.assert_allclose(n(got_sd[k]), ref_sd[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_load_pretrained_g_matches_jax(tmp_path):
    """A training checkpoint in the reference layout (weight_g / weight_v
    pairs, enc_q included) loads into the same tree through both."""
    tree = from_jax.random_synthesizer_tree(TCFG.model, seed=6)
    sd = {k: torch.as_tensor(np.ascontiguousarray(v))
          for k, v in jexport.synthesizer_state_dict(tree, JCFG.model).items()}
    q = tree["enc_q"]
    sd["enc_q.pre.weight"] = t(q["pre"]["w"].T[:, :, None])
    sd["enc_q.pre.bias"] = t(q["pre"]["b"])
    sd["enc_q.proj.weight"] = t(q["proj"]["w"].T[:, :, None])
    sd["enc_q.proj.bias"] = t(q["proj"]["b"])
    enc = q["enc"]
    for name, layers in (("in_layers", enc["in_layers"]), ("res_skip_layers", enc["res_skip"])):
        for i, c in enumerate(layers):
            w = c["w"].transpose(2, 1, 0) if c["w"].ndim == 3 else c["w"].T[:, :, None]
            sd[f"enc_q.enc.{name}.{i}.weight_g"] = t(np.sqrt((w ** 2).sum((1, 2), keepdims=True)))
            sd[f"enc_q.enc.{name}.{i}.weight_v"] = t(w)
            sd[f"enc_q.enc.{name}.{i}.bias"] = t(c["b"])
    cw = enc["cond"]["w"].T[:, :, None]
    sd["enc_q.enc.cond_layer.weight_g"] = t(np.sqrt((cw ** 2).sum((1, 2), keepdims=True)))
    sd["enc_q.enc.cond_layer.weight_v"] = t(cw)
    sd["enc_q.enc.cond_layer.bias"] = t(enc["cond"]["b"])
    path = str(tmp_path / "f0G48k.pth")
    torch.save({"model": sd, "iteration": 1}, path)
    got = tpth.load_pretrained_g(path, TCFG.model)
    ref = from_jax.synthesizer_from_jax(tree_np(jimport.load_pretrained_g(path, JCFG.model)),
                                        TCFG.model, train=True)
    a, r = ttrain.tree_leaves(got), ttrain.tree_leaves(ref)
    assert len(a) == len(r) and "enc_q" in got
    for x, y in zip(a, r):
        np.testing.assert_allclose(n(x), n(y), rtol=1e-5, atol=1e-6)


def test_entry_points_raise_without_card(prepared, models):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would run on it")
    from rvc_maker_tpu_torch import cli

    _, exp = prepared
    with pytest.raises(RuntimeError, match="cuda"):
        tloop.train(str(exp), TCFG, total_epochs=1)
    with pytest.raises(RuntimeError, match="cuda"):
        textract.extract_f0(str(exp), models["rmvpe"])
    with pytest.raises(RuntimeError, match="cuda"):
        textract.extract_embeddings(str(exp), models["hubert"])
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["train", "--exp-dir", str(exp), "--epochs", "1"])


def test_cli_flow_mrf_with_index(tmp_path, monkeypatch, caplog):
    """The training CLI end to end on the CPU at this file's narrow size:
    preprocess -> extract (no rmvpe file: yin; no embedder: a random
    HuBERT) -> train --vocoder "MRF HiFi-GAN" (TensorBoard logs) -> index
    (.npz, total_fea.npy, faiss added_*.index) -> convert --index with
    each of the three.  The exported .pth loads in the JAX loader to the
    port loader's weights."""
    from rvc_maker_tpu_torch import cli
    from rvc_maker_tpu_torch import config as cfg_mod
    from rvc_maker_tpu_torch.utils.i18n import tr

    def narrow_preset(version="v2", sample_rate=SR, *, vocoder="Default", pitch_guidance=True):
        return dataclasses.replace(TCFG, model=dataclasses.replace(
            TCFG.model, vocoder=vocoder, use_f0=pitch_guidance))

    monkeypatch.setattr(cfg_mod, "preset", narrow_preset)
    monkeypatch.setattr(tloop, "train", functools.partial(tloop.train, disc_width_div=16))
    _dataset(tmp_path / "dataset")
    exp = str(tmp_path / "voice")
    common = ["--exp-dir", exp, "--device", "cpu"]
    assert cli.main(["preprocess", "--dataset", str(tmp_path / "dataset"), "--exp-dir", exp,
                     "--sample-rate", str(SR), "--per", "1.0", "--cpu-cores", "1"]) == 0
    with caplog.at_level(logging.WARNING):
        assert cli.main(["extract", *common, "--sample-rate", str(SR)]) == 0
    assert tr("fallback_yin") in caplog.text and tr("random_hubert") in caplog.text
    assert len(os.listdir(os.path.join(exp, "f0_voiced"))) == 4
    assert cli.main(["train", *common, "--sample-rate", str(SR), "--epochs", "1",
                     "--batch-size", "2", "--save-every-epoch", "1",
                     "--vocoder", "MRF HiFi-GAN", "--no-pretrained"]) == 0
    pths = [f for f in os.listdir(exp) if f.endswith(".pth")]
    assert len(pths) == 1 and any(f.startswith("events") for f in os.listdir(
        os.path.join(exp, "tb")))
    assert cli.main(["index", *common]) == 0
    stem = os.path.join(exp, "added_voice_v2")
    vectors = np.load(os.path.join(exp, "total_fea.npy"))
    assert vectors.shape[1] == 768 and vectors.shape[0] > 100
    for path in (stem + ".index.npz", stem + ".index", os.path.join(exp, "total_fea.npy")):
        np.testing.assert_array_equal(jload_index(path).vectors, vectors)

    hubert_pt = tmp_path / "hubert.pt"
    torch.save({"model": hubert_state_dict(from_jax.random_hubert_tree(seed=0))}, hubert_pt)
    save_wav(str(tmp_path / "in.wav"), (0.3 * np.sin(2 * np.pi * 190 * np.arange(24000)
                                                     / 16000)).astype(np.float32), 16000)
    outs = []
    for path in (stem + ".index.npz", stem + ".index", os.path.join(exp, "total_fea.npy")):
        out = str(tmp_path / "out.wav")
        assert cli.main(["convert", "--input", str(tmp_path / "in.wav"), "--output", out,
                         "--model", os.path.join(exp, pths[0]), "--hubert-path",
                         str(hubert_pt), "--f0-method", "yin", "--index", path,
                         "--index-rate", "0.75", "--device", "cpu"]) == 0
        audio, sr = read_wav(out)
        assert sr == SR and np.isfinite(audio).all() and abs(len(audio) / SR - 1.5) < 0.2
        outs.append(audio)
    # the three files hold the same vectors: the same conversion
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-6)
    np.testing.assert_allclose(outs[2], outs[0], atol=1e-6)

    tparams, tcfg, _ = tpth.load_synthesizer_pth(os.path.join(exp, pths[0]))
    jparams, jcfg, _ = jimport.load_synthesizer_pth(os.path.join(exp, pths[0]))
    assert tcfg.vocoder == jcfg.vocoder == "MRF HiFi-GAN" and tcfg.use_f0
    got = ttrain.tree_leaves(tparams)
    ref = ttrain.tree_leaves(from_jax.synthesizer_from_jax(tree_np(jparams), tcfg))
    assert len(got) == len(ref)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(n(a), n(r), rtol=1e-5, atol=1e-6)
