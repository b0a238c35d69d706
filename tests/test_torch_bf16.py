"""bf16 mode of the port: ConvertPipeline(compute_dtype=torch.bfloat16)
against the JAX package's bf16 mode (compute_dtype=jnp.bfloat16) on the
same weights and the same noise, drawn in bf16 as JAX draws it, and
against the port's own fp32 path at the thresholds of JAX
`tests/test_bf16_mode.py` (correlation > 0.98, max abs < 0.1, pitchf on
yin within rtol 1e-5 / atol 1e-4, log-mel distance <= 0.40 on that
file's fixture).  Also `cast_floats` against JAX's and the i18n copy's
catalogs against JAX's.  Sizes are `CFG_M`'s, as the JAX bf16 tests
run them; the distances are printed (-s).
"""

import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu.config import ModelConfig as JaxModelConfig
from rvc_maker_tpu.models import hubert as jax_hubert
from rvc_maker_tpu.models import synthesizer as jax_syn
from rvc_maker_tpu.pipelines.convert import ConvertPipeline as JaxPipeline
from rvc_maker_tpu.pipelines.convert import ConvertSettings as JaxSettings
from rvc_maker_tpu_torch.config import ModelConfig
from rvc_maker_tpu_torch.interop import from_jax
from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline, ConvertSettings
from torch_port_util import (jax_decoder_noise, jax_noise, n, torch_threads,  # noqa: F401
                             tree_np)

JCFG_M = JaxModelConfig(
    spec_channels=129, segment_size=8, inter_channels=32, hidden_channels=32,
    filter_channels=64, n_heads=2, n_layers=1, kernel_size=3,
    resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
    upsample_rates=(4, 4, 2, 2), upsample_initial_channel=32,
    upsample_kernel_sizes=(8, 8, 4, 4), spk_embed_dim=4, gin_channels=16,
    sr=6400, use_f0=True, text_enc_hidden_dim=768)
RMVPE_WIDTHS = dict(widths=(4, 8, 16, 32, 64), inter_width=128)
CORR_MIN, MAX_ABS = 0.98, 0.1          # JAX test_bf16_close_to_fp32
MEL_GATE = 0.40                        # JAX test_bf16_mel_distance_gate


def _cfg(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


def _corr(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))


@pytest.fixture(scope="module")
def jax_trees():
    """JAX test_bf16_mode.py's weights: init_params(PRNGKey(0)) and a
    2-layer HuBERT from PRNGKey(1); RMVPE narrow; a 200 x 768 index."""
    return {"synth": jax_syn.init_params(jax.random.PRNGKey(0), JCFG_M),
            "hubert": jax_hubert.init_params(jax.random.PRNGKey(1), n_layers=2),
            "rmvpe": from_jax.random_rmvpe_tree(seed=2, **RMVPE_WIDTHS),
            "index": np.random.RandomState(3).randn(200, 768).astype(np.float32)}


def _port_pipe(trees, jcfg, synth, dtype, **kw):
    cfg = _cfg(jcfg)
    return ConvertPipeline(from_jax.synthesizer_from_jax(tree_np(synth), cfg), cfg,
                           from_jax.hubert_from_jax(tree_np(trees["hubert"])), version="v2",
                           rmvpe_params=from_jax.rmvpe_from_jax(trees["rmvpe"]),
                           index_vectors=trees["index"], device="cpu",
                           compute_dtype=dtype, **kw)


def _tone(seconds=2.0):
    t = np.arange(int(16000 * seconds)) / 16000
    return (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)[None]


# (decoder, f0 method, index rate): the NSF decode on yin and on RMVPE
# with the index, and the other two decoders of f0 models.  The RMVPE
# case decodes on JAX's f0: RMVPE's salience net runs bf16 and its
# argmax flips where the random net's salience is flat (each framework
# rounds otherwise; test_bf16_rmvpe_salience_as_close_as_jax holds it)
JAX_CASES = [("Default", "yin", 0.0), ("Default", "rmvpe", 0.5),
             ("MRF HiFi-GAN", "yin", 0.0), ("RefineGAN", "yin", 0.0)]


@pytest.mark.parametrize("vocoder,method,index_rate", JAX_CASES,
                         ids=["nsf-yin", "nsf-rmvpe-index", "mrf", "refinegan"])
def test_bf16_convert_batch_matches_jax_bf16(jax_trees, vocoder, method, index_rate):
    jcfg = dataclasses.replace(JCFG_M, vocoder=vocoder)
    synth = (jax_trees["synth"] if vocoder == "Default"
             else jax_syn.init_params(jax.random.PRNGKey(0), jcfg))
    jp = JaxPipeline(synth, jcfg, jax_trees["hubert"], version="v2",
                     rmvpe_params=jax.tree_util.tree_map(jnp.asarray, jax_trees["rmvpe"]),
                     index_vectors=jax_trees["index"], compute_dtype=jnp.bfloat16)
    port = _port_pipe(jax_trees, jcfg, synth, torch.bfloat16)
    audio = _tone()
    lengths = np.asarray([audio.shape[1]])
    knobs = dict(f0_method=method, index_rate=index_rate, deterministic=True)
    wav_j, pf_j = jp.convert_batch(audio, lengths, 0, JaxSettings(**knobs))
    p_len = port.frames(audio.shape[1])
    if vocoder == "Default":
        z, sine = jax_noise(1, p_len, jcfg.inter_channels, jcfg.upp, dtype=jnp.bfloat16)
        noise = {"sine": sine}
    else:
        z, noise = jax_decoder_noise(_cfg(jcfg), 1, p_len, dtype=jnp.bfloat16)
    if method == "rmvpe":
        f0_j = np.zeros((1, audio.shape[1] // 160 + 1), np.float32)
        f0_j[:, :p_len] = np.asarray(pf_j)
        port._f0 = lambda a, s: torch.as_tensor(f0_j)
    wav, pf = port.convert_batch(audio, lengths, 0, ConvertSettings(**knobs),
                                 z_noise=z, noise=noise)
    assert wav.dtype == torch.float32 and pf.dtype == torch.float32
    a, b = n(wav)[0], np.asarray(wav_j, np.float32)[0]
    corr, err = _corr(a, b), float(np.abs(a - b).max())
    print(f"\n{vocoder} {method}: port bf16 vs JAX bf16 corr {corr:.6f}, max abs {err:.3e} "
          f"(|wav|max {np.abs(b).max():.3f}); pitchf max abs "
          f"{np.abs(n(pf) - np.asarray(pf_j)).max():.3e} Hz")
    assert np.isfinite(a).all()
    assert corr > CORR_MIN and err < MAX_ABS, (corr, err)


def test_bf16_rmvpe_salience_as_close_as_jax(jax_trees):
    """RMVPE's salience net in bf16: the port's is no farther from its
    fp32 salience than JAX's bf16 is from JAX's fp32 (x1.5), and the fp32
    saliences agree within 1e-4.  The f0 distance is printed."""
    from rvc_maker_tpu.models import rmvpe as jax_rmvpe
    from rvc_maker_tpu.ops.nn import cast_floats as jax_cast
    from rvc_maker_tpu_torch.models import rmvpe as rmvpe_mod
    from rvc_maker_tpu_torch.ops.nn import cast_floats

    audio = _tone()
    mel = jax_rmvpe.rmvpe_mel(jnp.asarray(audio))
    n_frames = mel.shape[-1]
    mel = jnp.pad(mel, ((0, 0), (0, 0), (0, 32 * ((n_frames - 1) // 32 + 1) - n_frames)),
                  mode="reflect")
    sal, f0 = {}, {}
    for name, jdt, tdt in (("fp32", jnp.float32, torch.float32),
                           ("bf16", jnp.bfloat16, torch.bfloat16)):
        jp = jax_cast(jax.tree_util.tree_map(jnp.asarray, jax_trees["rmvpe"]), jdt)
        ref = jax_rmvpe.e2e_apply(jp, mel.astype(jdt))[:, :n_frames].astype(jnp.float32)
        params = cast_floats(from_jax.rmvpe_from_jax(jax_trees["rmvpe"]), tdt)
        with torch.inference_mode():
            f0[name], got = rmvpe_mod.infer(params, torch.as_tensor(audio), return_salience=True)
        sal[name] = (np.asarray(ref), n(got))
        f0[name] = (np.asarray(jax_rmvpe.decode_cents(ref)), n(f0[name]))
    jax_drift = float(np.abs(sal["bf16"][0] - sal["fp32"][0]).max())
    port_drift = float(np.abs(sal["bf16"][1] - sal["fp32"][1]).max())
    print(f"\nRMVPE salience bf16 vs fp32: JAX {jax_drift:.3e}, port {port_drift:.3e}; port vs "
          f"JAX in bf16 {np.abs(sal['bf16'][0] - sal['bf16'][1]).max():.3e}; f0 port vs JAX "
          f"in bf16 {np.abs(f0['bf16'][0][:, :n_frames] - f0['bf16'][1]).max():.3e} Hz")
    np.testing.assert_allclose(sal["fp32"][1], sal["fp32"][0], atol=1e-4)
    assert port_drift <= 1.5 * jax_drift, (port_drift, jax_drift)


@pytest.fixture(scope="module")
def port_pair(jax_trees):
    return {dt: _port_pipe(jax_trees, JCFG_M, jax_trees["synth"], dt)
            for dt in (None, torch.bfloat16)}


def test_bf16_close_to_fp32(port_pair):
    """JAX test_bf16_close_to_fp32, on the port: the f0 path is fp32 in
    both modes, the waveforms correlate."""
    audio = _tone()
    settings = ConvertSettings(f0_method="yin", index_rate=0.0, deterministic=True)
    wav32, pf32 = port_pair[None].convert_batch(audio, [audio.shape[1]], 0, settings)
    wav16, pf16 = port_pair[torch.bfloat16].convert_batch(audio, [audio.shape[1]], 0, settings)
    assert wav16.dtype == torch.float32
    np.testing.assert_allclose(n(pf16), n(pf32), rtol=1e-5, atol=1e-4)
    a, b = n(wav32)[0], n(wav16)[0]
    corr, err = _corr(a, b), float(np.abs(a - b).max())
    print(f"\nport bf16 vs port fp32: corr {corr:.6f}, max abs {err:.3e}")
    assert corr > CORR_MIN and err < MAX_ABS, (corr, err)


def test_bf16_mel_distance_gate(port_pair):
    """JAX test_bf16_mel_distance_gate's fixture and gate, on the port:
    mean |log-mel(bf16) - log-mel(fp32)| <= 0.40, the log-mel computed
    by the JAX package's STFT and filterbank."""
    from rvc_maker_tpu.ops.stft import hann_window, mel_filterbank, stft_magnitude

    rs = np.random.RandomState(7)
    t = np.arange(32000) / 16000
    audio = (0.25 * np.sin(2 * np.pi * (180 + 20 * np.sin(2 * np.pi * 3 * t)) * t)
             + 0.02 * rs.randn(len(t))).astype(np.float32)[None]
    settings = ConvertSettings(f0_method="yin", index_rate=0.0, deterministic=True)
    wavs = [n(port_pair[dt].convert_batch(audio, [32000], 0, settings)[0])[0]
            for dt in (torch.bfloat16, None)]
    n_fft, hop = 512, 128
    win = hann_window(n_fft)
    fb = mel_filterbank(JCFG_M.sr, n_fft, 40, 0.0, JCFG_M.sr / 2)

    def logmel(w):
        mag = stft_magnitude(jnp.asarray(w[None]), n_fft=n_fft, hop_length=hop,
                             win_length=n_fft, window=win, center=True)[0]
        return np.log(np.asarray(mag @ fb.T) + 1e-5)

    dist = float(np.mean(np.abs(logmel(wavs[0]) - logmel(wavs[1]))))
    print(f"\nport bf16 vs fp32 log-mel distance {dist:.4f} (gate {MEL_GATE})")
    assert dist <= MEL_GATE, dist


def test_bf16_pipeline_casts_like_jax(port_pair, jax_trees):
    """What is bf16 and what stays fp32: the networks' weights and the
    index in bf16; RMVPE's GRU module cast with them; CREPE (none here)
    and the F0 decodes fp32; the caller's trees untouched."""
    p16 = port_pair[torch.bfloat16]
    assert p16.compute_dtype is torch.bfloat16 and port_pair[None].compute_dtype is None
    assert p16.synth_params["dec"]["conv_pre"]["w"].dtype == torch.bfloat16
    assert p16.hubert_params["post_proj"]["w"].dtype == torch.bfloat16
    assert p16.index_vectors.dtype == torch.bfloat16
    assert next(p16.rmvpe_params["gru"].parameters()).dtype == torch.bfloat16
    assert next(port_pair[None].rmvpe_params["gru"].parameters()).dtype == torch.float32
    with pytest.raises(ValueError, match="compute_dtype"):
        _port_pipe(jax_trees, JCFG_M, jax_trees["synth"], torch.float16)


def test_bf16_fcpe_decodes_in_fp32(jax_trees):
    """FCPE's weights are cast, its cent table (a decode constant) stays
    fp32, and a bf16 fcpe conversion runs and returns fp32."""
    fcpe = from_jax.fcpe_from_jax(from_jax.random_fcpe_tree(4, 64, 2))
    p16 = _port_pipe(jax_trees, JCFG_M, jax_trees["synth"], torch.bfloat16, fcpe_params=fcpe)
    assert p16.fcpe_params["in_conv1"]["w"].dtype == torch.bfloat16
    assert p16.fcpe_params["cent_table"].dtype == torch.float32
    assert torch.equal(p16.fcpe_params["cent_table"], fcpe["cent_table"])
    audio = _tone()
    wav, pf = p16.convert_batch(audio, [audio.shape[1]], 0,
                                ConvertSettings(f0_method="fcpe", deterministic=True))
    assert wav.dtype == pf.dtype == torch.float32 and torch.isfinite(wav).all()


def test_bf16_deterministic_and_noise_dtype(port_pair):
    """deterministic works in bf16, and the drawn noise is bf16 (the
    compute dtype, JAX convert.py:544-547) with rand_ini fp32."""
    p16 = port_pair[torch.bfloat16]
    audio = _tone(1.0)
    settings = ConvertSettings(f0_method="yin", deterministic=True)
    w1, _ = p16.convert_batch(audio, [16000], 0, settings,
                              generator=torch.Generator().manual_seed(5))
    w2, _ = p16.convert_batch(audio, [16000], 0, settings)
    assert torch.equal(w1, w2)
    z, noise = p16.draw_noise(1, 10, torch.Generator().manual_seed(0))
    assert z.dtype == noise["sine"].dtype == torch.bfloat16
    mrf = dataclasses.replace(_cfg(JCFG_M), vocoder="MRF HiFi-GAN")
    from rvc_maker_tpu_torch.models.synthesizer import decoder_noise

    dn = decoder_noise(mrf, 1, 10, torch.Generator().manual_seed(0), "cpu", torch.bfloat16)
    assert dn["source"].dtype == torch.bfloat16 and dn["rand_ini"].dtype == torch.float32


def _cast_tree():
    rs = np.random.RandomState(0)
    return {"w": rs.randn(3, 4).astype(np.float32), "ids": np.arange(5, dtype=np.int32),
            "mask": np.array([True, False]),
            "layers": [{"b": rs.randn(4).astype(np.float32),
                        "h": rs.randn(2).astype(np.float16)},
                       (rs.randn(2, 2).astype(np.float32), np.int64(7))]}


def _leaves(tree):
    """Leaves in jax.tree_util's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_cast_floats_matches_jax():
    from rvc_maker_tpu.ops.nn import cast_floats as jax_cast
    from rvc_maker_tpu_torch.ops.nn import cast_floats

    tree = _cast_tree()
    ref = jax.tree_util.tree_leaves(jax_cast(tree, jnp.bfloat16))
    got = _leaves(cast_floats(
        jax.tree_util.tree_map(lambda a: torch.as_tensor(np.asarray(a)), tree), torch.bfloat16))
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        r = np.asarray(r)
        if jnp.issubdtype(r.dtype, jnp.floating):
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.float().numpy(), r.astype(np.float32))
        else:
            assert not g.is_floating_point()
            np.testing.assert_array_equal(g.numpy(), r)


def test_cast_floats_copies_modules():
    from rvc_maker_tpu_torch.ops.nn import cast_floats

    gru = torch.nn.GRU(4, 3)
    out = cast_floats({"gru": gru, "step": torch.tensor(3)}, torch.bfloat16)
    assert next(out["gru"].parameters()).dtype == torch.bfloat16
    assert next(gru.parameters()).dtype == torch.float32
    assert out["step"].dtype == torch.int64


LOCALES = ["en-US", "id_ID", "ja-JP", "vi-VN"]


@pytest.mark.parametrize("lang", LOCALES)
def test_i18n_catalog_matches_jax(lang):
    """The copied locale files are byte for byte JAX's, and each locale's
    catalog equals JAX's."""
    from rvc_maker_tpu.utils import i18n as jax_i18n
    from rvc_maker_tpu_torch.utils import i18n

    jax_dir = os.path.join(os.path.dirname(jax_i18n.__file__), "languages")
    assert i18n.available_languages() == jax_i18n.available_languages() == LOCALES
    assert filecmp.cmp(os.path.join(jax_dir, f"{lang}.json"),
                       os.path.join(i18n.LANG_DIR, f"{lang}.json"), shallow=False)
    try:
        jax_i18n.set_language(lang)
        i18n.set_language(lang)
        ref, got = jax_i18n.catalog(), i18n.catalog()
        assert got == ref
        assert i18n.tr("bad_request", path="/x", error="e") == jax_i18n.tr(
            "bad_request", path="/x", error="e")
    finally:
        jax_i18n.set_language("en-US")
        i18n.set_language("en-US")
