"""The port's other decoders against the JAX package's, on the same
weights (carried across by interop/from_jax.py) and the same explicit
noise: the plain decoder of f0-less models (`generator`), MRF-HiFi-GAN
and RefineGAN (models/vocoders.py), `infer` / `infer_any`, the .pth
round trips in both directions, `convert_batch` against the JAX
ConvertPipeline and `cli convert` on each kind of .pth.  Modules atol
1e-4; waveforms of the pipeline <= 1e-3."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu.config import ModelConfig as JaxModelConfig
from rvc_maker_tpu.config import model_config_to_ckpt_list
from rvc_maker_tpu.interop.torch_export import synthesizer_state_dict as jax_state_dict
from rvc_maker_tpu.interop.torch_import import load_synthesizer_pth as jax_load_pth
from rvc_maker_tpu.models import synthesizer as jsyn
from rvc_maker_tpu.models import vocoders as jvoc
from rvc_maker_tpu.pipelines.convert import ConvertPipeline as JaxPipeline
from rvc_maker_tpu.pipelines.convert import ConvertSettings as JaxSettings
from rvc_maker_tpu.retrieval.faiss_io import write_ivf_flat
from rvc_maker_tpu_torch.config import ModelConfig
from rvc_maker_tpu_torch.interop import from_jax
from rvc_maker_tpu_torch.interop.pth import load_synthesizer_pth, synthesizer_state_dict
from rvc_maker_tpu_torch.models import synthesizer as tsyn
from rvc_maker_tpu_torch.models import vocoders as tvoc
from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline, ConvertSettings
from torch_port_util import (jax_decoder_noise, n, run_cli_convert, t, torch_threads,  # noqa: F401
                             tree_np, voice)

ATOL = 1e-4
WAVE_ATOL = 1e-3

BASE = JaxModelConfig(
    spec_channels=129, segment_size=8, inter_channels=32, hidden_channels=32,
    filter_channels=64, n_heads=2, n_layers=1, kernel_size=3,
    resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)),
    upsample_rates=(4, 4, 2, 2), upsample_initial_channel=64,
    upsample_kernel_sizes=(8, 8, 4, 4), spk_embed_dim=4, gin_channels=16,
    sr=6400, use_f0=True, text_enc_hidden_dim=768)
KINDS = {"plain": dict(use_f0=False), "mrf": dict(vocoder="MRF HiFi-GAN"),
         "refinegan": dict(vocoder="RefineGAN")}


def _cfgs(kind):
    jcfg = dataclasses.replace(BASE, **KINDS[kind])
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _tree(kind, seed=0):
    """Random weights of one kind, scaled up in the decode, so that the
    waveform spans a good part of [-1, 1] and 1e-3 is a tight bound."""
    _, cfg = _cfgs(kind)
    tree = from_jax.random_synthesizer_tree(cfg, seed=seed)
    dec = tree["dec"]
    if kind == "refinegan":
        dec["conv_post"]["w"] *= 30.0
        for blk in dec["upsample_conv_blocks"]:
            blk["input_conv"]["w"] *= 10.0
    else:
        for u in dec["ups"]:
            u["w"] *= 20.0
        dec["conv_post"]["w"] *= 20.0
    return tree


@pytest.fixture(scope="module")
def trees():
    return {kind: _tree(kind) for kind in KINDS}


_jit_plain = jax.jit(jsyn.generator, static_argnums=(1,))
_jit_mrf = jax.jit(jvoc.mrf_hifigan, static_argnums=(1,))
_jit_refinegan = jax.jit(jvoc.refinegan, static_argnums=(1,))
_jit_interp = jax.jit(jvoc.interp_linear, static_argnums=(1,))
_jit_infer = jax.jit(lambda p, cfg, *a: jsyn.infer(p, cfg, *a)[0], static_argnums=(1,))
_jit_infer_any = jax.jit(jsyn.infer_any, static_argnums=(1,))


def _torch_noise(noise):
    if isinstance(noise, dict):
        return {k: _torch_noise(v) for k, v in noise.items()}
    if isinstance(noise, (list, tuple)):
        return type(noise)(_torch_noise(v) for v in noise)
    return t(noise)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t_in,size", [(7, 23), (50, 13), (998, 998 * 480)])
def test_interp_linear_matches_jax(t_in, size):
    """F.interpolate against the jitted JAX formula; at 2 x 998 frames to
    479,040 samples (10 s at 48 kHz, RefineGAN's f0 upsampling), the
    position's rounding decides the result: within 1e-6 x max|x|."""
    x = np.random.RandomState(t_in).uniform(80, 300, (2, t_in, 3)).astype(np.float32)
    ref = n(_jit_interp(jnp.asarray(x), size))
    got = n(tvoc.interp_linear(t(x).transpose(1, 2), size).transpose(1, 2))
    assert got.shape == (2, size, 3)
    err = np.abs(got - ref).max()
    assert err <= 1e-6 * np.abs(x).max(), err


def _harmonics(T, seed=1):
    """9 harmonics of an f0 in 80-300 Hz held for 80 samples at a time,
    with an unvoiced run, and a random initial phase per harmonic."""
    rs = np.random.RandomState(seed)
    f0 = np.repeat(rs.uniform(80, 300, (2, T // 80)), 80, axis=1).astype(np.float32)
    f0[:, T // 8:T // 4] = 0.0
    ini = rs.rand(2, 9).astype(np.float32)
    ini[:, 0] = 0.0
    return f0[:, :, None] * np.arange(1, 10, dtype=np.float32), ini


def test_cumsum_sine_matches_jax():
    """2,000 samples at 16 kHz (the running sum reaches about 340 before
    its wraps come out)."""
    buf, ini = _harmonics(2000)
    ref = jax.jit(lambda b, r: jvoc.cumsum_sine(b, r, sample_rate=16000))(buf, ini)
    got = tvoc.cumsum_sine(t(buf), t(ini), sample_rate=16000)
    np.testing.assert_allclose(n(got), n(ref), atol=ATOL)


def test_cumsum_sine_long_against_float64():
    """479,040 samples at 48 kHz (10 s, a full-width MRF source) against
    the phase summed plainly in float64 with numpy, within 1e-4.  The
    jitted JAX function sums fp32 in another order and drifts further
    (printed beside the port's distance), so the port is held to
    float64 at this length and to JAX on short ones."""
    buf, ini = _harmonics(479040)
    got = n(tvoc.cumsum_sine(t(buf), t(ini), sample_rate=48000))
    rad = np.mod(buf.astype(np.float64) / 48000, 1.0)
    rad[:, 0] += ini
    ref = np.sin(2 * np.pi * np.mod(np.cumsum(rad, axis=1), 1.0))
    jax_ref = n(jax.jit(lambda b, r: jvoc.cumsum_sine(b, r, sample_rate=48000))(buf, ini))
    err = np.abs(got - ref).max()
    print(f"cumsum_sine at 479,040 samples, max abs from float64: port {err:.3e}, "
          f"jitted JAX {np.abs(jax_ref - ref).max():.3e}")
    assert err <= ATOL, err


def _dec_inputs(kind, T=24, b=2, seed=4):
    jcfg, _ = _cfgs(kind)
    rs = np.random.RandomState(seed)
    x = (rs.randn(b, T, jcfg.inter_channels) * 0.5).astype(np.float32)
    f0 = rs.uniform(100, 300, (b, T)).astype(np.float32)
    f0[:, ::5] = 0.0
    g = (rs.randn(b, 1, jcfg.gin_channels) * 0.3).astype(np.float32)
    return x, f0, g


def test_generator_plain_matches_jax(trees):
    jcfg, cfg = _cfgs("plain")
    tree = trees["plain"]
    x, _, g = _dec_inputs("plain")
    ref = _jit_plain(jax.tree_util.tree_map(jnp.asarray, tree["dec"]), jcfg, x, g)
    got = tsyn.generator(from_jax.synthesizer_from_jax(tree, cfg)["dec"], cfg, t(x), t(g))
    assert got.shape == (2, 24 * cfg.upp, 1) and np.abs(n(ref)).max() > 0.1
    np.testing.assert_allclose(n(got), n(ref), atol=ATOL)


def test_mrf_hifigan_matches_jax(trees):
    jcfg, cfg = _cfgs("mrf")
    tree = trees["mrf"]
    x, f0, g = _dec_inputs("mrf")
    _, noise = jax_decoder_noise(jcfg, 2, 24, seed=3)
    ref = _jit_mrf(jax.tree_util.tree_map(jnp.asarray, tree["dec"]), jcfg, x, f0, g,
                   noise["source"], noise["rand_ini"])
    got = tvoc.mrf_hifigan(from_jax.synthesizer_from_jax(tree, cfg)["dec"], cfg, t(x),
                           t(f0), t(g), t(noise["source"]), t(noise["rand_ini"]))
    assert got.shape == (2, 24 * cfg.upp, 1) and np.abs(n(ref)).max() > 0.1
    np.testing.assert_allclose(n(got), n(ref), atol=ATOL)


def test_refinegan_matches_jax(trees):
    """With AdaIN noise drawn N(0, 1), so the noise injection counts."""
    jcfg, cfg = _cfgs("refinegan")
    tree = trees["refinegan"]
    x, f0, g = _dec_inputs("refinegan")
    _, noise = jax_decoder_noise(jcfg, 2, 24, seed=5)
    assert np.abs(noise["adain"][0][0][0]).max() > 1.0
    ref = _jit_refinegan(jax.tree_util.tree_map(jnp.asarray, tree["dec"]), jcfg, x, f0, g,
                         noise["source"], noise["adain"], noise["rand_ini"])
    got = tvoc.refinegan(from_jax.synthesizer_from_jax(tree, cfg)["dec"], cfg, t(x), t(f0),
                         t(g), t(noise["source"]), _torch_noise(noise["adain"]),
                         t(noise["rand_ini"]))
    assert got.shape == (2, 24 * cfg.upp, 1) and np.abs(n(ref)).max() > 0.1
    np.testing.assert_allclose(n(got), n(ref), atol=ATOL)


# ---------------------------------------------------------------------------
# the synthesizer
# ---------------------------------------------------------------------------

def _synth_inputs(jcfg, b=2, T=30, seed=1):
    rs = np.random.RandomState(seed)
    phone = rs.randn(b, T, jcfg.text_enc_hidden_dim).astype(np.float32)
    lengths = np.array([T, T - 5][:b], np.int64)
    f0 = rs.uniform(80, 400, (b, T)).astype(np.float32)
    f0[:, ::7] = 0.0
    pitch = rs.randint(1, 255, (b, T)) if jcfg.use_f0 else None
    return phone, lengths, pitch, f0, np.arange(b)


def test_infer_f0less_matches_jax(trees):
    """`infer` of an f0-less model: no pitch embedding, the plain decoder."""
    jcfg, cfg = _cfgs("plain")
    tree = trees["plain"]
    phone, lengths, pitch, f0, sid = _synth_inputs(jcfg)
    assert pitch is None and "emb_pitch" not in tree["enc_p"]
    z = np.random.RandomState(2).randn(2, 30, jcfg.inter_channels).astype(np.float32)
    ref = _jit_infer(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, phone, lengths, None,
                     f0, sid, z, None)
    got, _, _ = tsyn.infer(from_jax.synthesizer_from_jax(tree, cfg), cfg, t(phone),
                           torch.as_tensor(lengths), None, t(f0), torch.as_tensor(sid),
                           t(z), None)
    np.testing.assert_allclose(n(got), n(ref), atol=ATOL)


@pytest.mark.parametrize("kind", ["mrf", "refinegan", "plain"])
def test_infer_any_matches_jax(trees, kind):
    """JAX infer_any draws its noise from a key; the port takes the same
    draws, redrawn here from that key with jax.random."""
    jcfg, cfg = _cfgs(kind)
    tree = trees[kind]
    phone, lengths, pitch, f0, sid = _synth_inputs(jcfg)
    ref = _jit_infer_any(jax.tree_util.tree_map(jnp.asarray, tree), jcfg, phone, lengths,
                         pitch, f0, sid, jax.random.PRNGKey(7))
    z, noise = jax_decoder_noise(jcfg, 2, 30, seed=7)
    got = tsyn.infer_any(from_jax.synthesizer_from_jax(tree, cfg), cfg, t(phone),
                         torch.as_tensor(lengths),
                         None if pitch is None else torch.as_tensor(pitch), t(f0),
                         torch.as_tensor(sid), t(z), _torch_noise(noise))
    assert got.shape == (2, 30 * cfg.upp, 1) and np.abs(n(ref)).max() > 0.1
    np.testing.assert_allclose(n(got), n(ref), atol=ATOL)


def test_decoder_noise_layout():
    """decoder_noise draws the shapes JAX infer_any draws, in one fixed
    order from the generator: the same seed gives the same draws."""
    for kind in ("nsf", *KINDS):
        jcfg, cfg = _cfgs(kind) if kind in KINDS else (BASE, ModelConfig(
            **dataclasses.asdict(BASE)))
        draws = [tsyn.decoder_noise(cfg, 2, 5, torch.Generator().manual_seed(3), "cpu")
                 for _ in range(2)]
        _, ref = jax_decoder_noise(jcfg, 2, 5)
        flat = [jax.tree_util.tree_leaves(jax.tree_util.tree_map(n, d)) for d in draws]
        assert [a.shape for a in flat[0]] == [a.shape for a in jax.tree_util.tree_leaves(ref)]
        for a, b in zip(*flat):
            np.testing.assert_array_equal(a, b)
        if kind == "mrf":
            assert (flat[0][0][:, 0] == 0).all() and (flat[0][0][:, 1:] > 0).all()


@pytest.mark.parametrize("kind", list(KINDS))
def test_train_forward_not_ported(kind):
    """Training these decoders is ported (it was refused before): the
    training forward runs each one, its noise drawn from the generator,
    and gives a segment of upp samples per frame with gradients to the
    decoder.  tests/test_torch_train_vocoders.py holds it against JAX."""
    _, cfg = _cfgs(kind)
    params = from_jax.synthesizer_from_jax(from_jax.random_synthesizer_tree(cfg, seed=1), cfg,
                                           train=True)
    leaf = params["dec"]["conv_post"]["w"].requires_grad_(True)
    rs = np.random.RandomState(2)
    b, frames = 2, cfg.segment_size + 6
    lengths = torch.tensor([frames, frames - 3])
    y_hat, ids, *_ = tsyn.train_forward(
        params, cfg, t(rs.randn(b, frames, cfg.text_enc_hidden_dim)), lengths,
        torch.as_tensor(rs.randint(1, 256, (b, frames))) if cfg.use_f0 else None,
        t(rs.rand(b, frames) * 200 + 90), t(np.abs(rs.randn(b, frames, cfg.spec_channels))),
        lengths, torch.tensor([0, 1]), generator=torch.Generator().manual_seed(0))
    assert y_hat.shape == (b, cfg.segment_size * cfg.upp, 1) and torch.isfinite(y_hat).all()
    assert ((ids >= 0) & (ids <= lengths - cfg.segment_size)).all()
    (g,) = torch.autograd.grad(y_hat.square().sum(), [leaf])
    assert g.abs().max() > 0


# ---------------------------------------------------------------------------
# interchange files
# ---------------------------------------------------------------------------

def _save_pth(path, sd, jcfg):
    torch.save({"weight": {k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in sd.items()},
                "config": model_config_to_ckpt_list(jcfg), "f0": int(jcfg.use_f0),
                "version": "v2", "vocoder": jcfg.vocoder}, path)


def _port_infer_any(tp, cfg, jcfg, seed=9):
    phone, lengths, pitch, f0, sid = _synth_inputs(jcfg, seed=seed)
    z, noise = jax_decoder_noise(jcfg, 2, 30, seed=seed)
    return tsyn.infer_any(tp, cfg, t(phone), torch.as_tensor(lengths),
                          None if pitch is None else torch.as_tensor(pitch), t(f0),
                          torch.as_tensor(sid), t(z), _torch_noise(noise))


def _jax_infer_any(jp, jcfg, seed=9):
    phone, lengths, pitch, f0, sid = _synth_inputs(jcfg, seed=seed)
    return _jit_infer_any(jp, jcfg, phone, lengths, pitch, f0, sid,
                          jax.random.PRNGKey(seed))


@pytest.mark.parametrize("spelling", ["parametrizations", "weight_g"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_pth_from_jax_exporter(trees, tmp_path, kind, spelling):
    """A .pth written by the JAX exporter (both weight-norm spellings)
    through the port's loader: the same waveform as JAX."""
    jcfg, _ = _cfgs(kind)
    jp = jax.tree_util.tree_map(jnp.asarray, trees[kind])
    sd = jax_state_dict(tree_np(jp), jcfg)
    if spelling == "weight_g":
        sd = {k.replace("parametrizations.weight.original0", "weight_g")
               .replace("parametrizations.weight.original1", "weight_v"): v
              for k, v in sd.items()}
    assert any(spelling in k for k in sd)
    _save_pth(tmp_path / "model.pth", sd, jcfg)
    tp, cfg, meta = load_synthesizer_pth(str(tmp_path / "model.pth"))
    assert tsyn.decoder_kind(cfg) == kind and meta["vocoder"] == jcfg.vocoder
    assert ("emb_pitch" in tp["enc_p"]) == jcfg.use_f0
    err = np.abs(n(_port_infer_any(tp, cfg, jcfg)) - n(_jax_infer_any(jp, jcfg))).max()
    assert err <= WAVE_ATOL, err


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_export_loads_in_jax(trees, tmp_path, kind):
    """The port's export read back by the JAX package's loader: every
    key the JAX exporter writes, and the same waveform."""
    jcfg, cfg = _cfgs(kind)
    tp = from_jax.synthesizer_from_jax(trees[kind], cfg)
    sd = {k: n(v) for k, v in synthesizer_state_dict(tp, cfg).items()}
    assert set(sd) == set(jax_state_dict(trees[kind], jcfg))
    _save_pth(tmp_path / "model.pth", sd, jcfg)
    jp, jcfg2, _ = jax_load_pth(str(tmp_path / "model.pth"))
    assert jcfg2.vocoder == jcfg.vocoder and jcfg2.use_f0 == jcfg.use_f0
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    err = np.abs(n(_jax_infer_any(jp, jcfg)) - n(_port_infer_any(tp, cfg, jcfg))).max()
    assert err <= WAVE_ATOL, err


# ---------------------------------------------------------------------------
# the pipeline and the CLI
# ---------------------------------------------------------------------------

RMVPE_WIDTHS = dict(widths=(4, 8, 16, 32, 64), inter_width=128)


@pytest.fixture(scope="module")
def aux():
    return {"hubert": from_jax.random_hubert_tree(seed=1, n_layers=2),
            "rmvpe": from_jax.random_rmvpe_tree(seed=2, **RMVPE_WIDTHS),
            "index": np.random.RandomState(5).randn(300, 768).astype(np.float32)}


@pytest.mark.parametrize("kind", list(KINDS))
def test_convert_batch_matches_jax(trees, aux, kind):
    """B = 2 rows of different lengths in one 1 s bucket, the index on,
    protect on: the JAX pipeline's draws from PRNGKey(0) fed to the port
    (an f0-less model: JAX `infer` draws z from split(key)[0]).  Transposed
    an octave down, which keeps the random RMVPE's f0 under 1 kHz, in a
    voice's range: at its 2.2 kHz untransposed, the MRF source's 9th
    harmonic is where the jitted JAX cumsum's own fp32 rounding shows on
    the waveform (the port sums in float64)."""
    jcfg, cfg = _cfgs(kind)
    jp = jax.tree_util.tree_map(jnp.asarray, dict(aux, synth=trees[kind]))
    jax_pipe = JaxPipeline(jp["synth"], jcfg, jp["hubert"], version="v2",
                           rmvpe_params=jp["rmvpe"], index_vectors=aux["index"],
                           compute_dtype=None)
    port = ConvertPipeline(from_jax.synthesizer_from_jax(trees[kind], cfg), cfg,
                           from_jax.hubert_from_jax(aux["hubert"]), version="v2",
                           rmvpe_params=from_jax.rmvpe_from_jax(aux["rmvpe"]),
                           index_vectors=aux["index"], device="cpu")
    audio = np.stack([voice(1.0, 160.0, 1), voice(1.0, 240.0, 2)])
    audio[1, 12000:] = 0.0
    lengths = np.array([16000, 12000])
    settings = dict(index_rate=0.5, protect=0.33, pitch=-12)
    wav_j, pf_j = jax_pipe.convert_batch(audio, lengths, 1, JaxSettings(**settings))
    p_len = port.frames(audio.shape[1])
    assert 0 < n(pf_j).max() < 1000
    if kind == "plain":
        k1, _ = jax.random.split(jax.random.PRNGKey(0))
        z, noise = np.array(jax.random.normal(k1, (2, p_len, cfg.inter_channels))), {}
    else:
        z, noise = jax_decoder_noise(jcfg, 2, p_len, seed=0)
    wav, pf = port.convert_batch(audio, lengths, 1, ConvertSettings(**settings),
                                 z_noise=t(z), noise=_torch_noise(noise))
    assert wav.shape == (2, p_len * cfg.upp)
    np.testing.assert_allclose(n(pf), n(pf_j), atol=1e-2)
    err = np.abs(n(wav) - n(wav_j)).max()
    assert np.abs(n(wav_j)).max() > 0.1
    assert np.isfinite(n(wav)).all() and err <= WAVE_ATOL, err


@pytest.mark.parametrize("kind", list(KINDS))
def test_convert_batch_draws_only_missing_noise(trees, aux, kind):
    """convert_batch draws from its generator only the noise the caller
    did not give, z before the decoder's noise: given z, the decoder's
    noise is the generator's first draw; given the decoder's noise, z is;
    given neither, both come in `draw_noise`'s order."""
    _, cfg = _cfgs(kind)
    port = ConvertPipeline(from_jax.synthesizer_from_jax(trees[kind], cfg), cfg,
                           from_jax.hubert_from_jax(aux["hubert"]), version="v2",
                           rmvpe_params=from_jax.rmvpe_from_jax(aux["rmvpe"]),
                           device="cpu")
    audio = np.stack([voice(1.0, 160.0, 1), voice(1.0, 240.0, 2)])
    lengths = np.array([16000, 16000])
    p_len = port.frames(audio.shape[1])

    def gen():
        return torch.Generator().manual_seed(4)

    def run(**kw):
        return n(port.convert_batch(audio, lengths, 0, ConvertSettings(), **kw)[0])

    z, dn = port.draw_noise(2, p_len, torch.Generator().manual_seed(8))
    both = run(z_noise=z, noise=dn)
    np.testing.assert_allclose(
        run(z_noise=z, generator=gen()),
        run(z_noise=z, noise=tsyn.decoder_noise(cfg, 2, p_len, gen(), "cpu")), atol=1e-6)
    np.testing.assert_allclose(
        run(noise=dn, generator=gen()),
        run(z_noise=torch.randn((2, p_len, cfg.inter_channels), generator=gen()),
            noise=dn), atol=1e-6)
    z4, dn4 = port.draw_noise(2, p_len, gen())
    drawn = run(generator=gen())
    np.testing.assert_allclose(drawn, run(z_noise=z4, noise=dn4), atol=1e-6)
    assert np.abs(drawn - both).max() > 1e-3      # the noise reaches the waveform


@pytest.mark.parametrize("kind", list(KINDS))
def test_cli_convert_each_kind(trees, aux, tmp_path, kind):
    """`cli convert` on the CPU with a .pth of each kind as the JAX
    exporter writes it (fp16) and a faiss .index written by the JAX
    package's write_ivf_flat."""
    jcfg, _ = _cfgs(kind)
    index = aux["index"]
    write_ivf_flat(str(tmp_path / "added.index"), index, index[:4], np.arange(300) % 4)
    out, sr = run_cli_convert(tmp_path, jax_state_dict(trees[kind], jcfg), jcfg,
                              aux["hubert"], aux["rmvpe"], tmp_path / "added.index")
    assert sr == jcfg.sr
    assert abs(len(out) - 1.5 * jcfg.sr) <= 2 * jcfg.upp
    assert np.isfinite(out).all() and np.abs(out).max() > 0
