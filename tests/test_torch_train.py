"""The port's training path (pipelines/train.py, the synthesizer's training
forward, the training spectrograms) against the JAX package's, on the
tiny config of tests/test_train_step.py with disc_width_div=16.

The JAX step draws its noise from a PRNG key; the test computes those
draws (post noise, slice ids, sine noise) with jax.random and hands them
to the port explicitly.  The JAX side runs in one module-scoped jitted
program."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rvc_maker_tpu.config import DataConfig, ModelConfig, RVCConfig, TrainConfig
from rvc_maker_tpu.models import synthesizer as jsyn
from rvc_maker_tpu.ops import nn as jnn
from rvc_maker_tpu.ops import stft as jstft
from rvc_maker_tpu.pipelines import train as jtrain
from rvc_maker_tpu_torch import config as tconfig
from rvc_maker_tpu_torch.interop import from_jax
from rvc_maker_tpu_torch.models import synthesizer as tsyn
from rvc_maker_tpu_torch.ops import nn as tnn
from rvc_maker_tpu_torch.ops import stft as tstft
from rvc_maker_tpu_torch.pipelines import train as ttrain
from rvc_maker_tpu_torch.pipelines import train_loop as tloop
from torch_port_util import (assert_grads_close, n, rel_close, t, torch_threads,  # noqa: F401
                             tree_np)

HOP, SEG, B, T = 64, 8, 4, 24
DIV = 16

_MODEL = dict(
    spec_channels=129, segment_size=SEG, inter_channels=32, hidden_channels=32,
    filter_channels=64, n_heads=2, n_layers=1, kernel_size=3,
    resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
    upsample_rates=(4, 4, 2, 2), upsample_initial_channel=32,
    upsample_kernel_sizes=(8, 8, 4, 4), spk_embed_dim=4, gin_channels=16, sr=16000,
    use_f0=True, text_enc_hidden_dim=96)
_DATA = dict(sample_rate=16000, filter_length=256, hop_length=HOP, win_length=256,
             n_mel_channels=32)
JCFG = RVCConfig(version="v2", train=TrainConfig(segment_size=SEG * HOP),
                 data=DataConfig(**_DATA), model=ModelConfig(**_MODEL))
TCFG = tconfig.RVCConfig(version="v2", train=tconfig.TrainConfig(segment_size=SEG * HOP),
                         data=tconfig.DataConfig(**_DATA),
                         model=tconfig.ModelConfig(**_MODEL))


def _batch_np(seed=0, short=False):
    rs = np.random.RandomState(seed)
    lengths = np.full((B,), T, np.int32)
    if short:   # lengths near the segment: clamped slice starts
        lengths = np.array([T, SEG, SEG + 1, T - 3], np.int32)
    return dict(
        phone=rs.randn(B, T, 96).astype(np.float32), phone_lengths=lengths,
        pitch=rs.randint(1, 256, (B, T)).astype(np.int32),
        pitchf=(rs.rand(B, T) * 200 + 80).astype(np.float32),
        spec=np.abs(rs.randn(B, T, 129)).astype(np.float32), spec_lengths=lengths,
        wave=(rs.randn(B, T * HOP, 1) * 0.1).astype(np.float32),
        sid=rs.randint(0, 4, (B,)).astype(np.int32))


def _jax_draws(rng, lengths):
    """The noise the JAX step draws from `rng` (train.py train_step ->
    synthesizer.train_forward -> rand_slice_segments / _decode_train)."""
    rng_fwd, _ = jax.random.split(rng)
    k_post, k_slice, k_sine = jax.random.split(rng_fwd, 3)
    m = JCFG.model
    post = jax.random.normal(k_post, (B, T, m.inter_channels), jnp.float32)
    u = jax.random.uniform(k_slice, (B,))
    ids = (u * (jnp.asarray(lengths) - SEG + 1)).astype(jnp.int32)
    sine = jax.random.normal(k_sine, (B, SEG * m.upp, 1), jnp.float32)
    return dict(post_noise=np.asarray(post), ids_slice=np.asarray(ids),
                dec_noise={"sine": np.asarray(sine)})


@pytest.fixture(scope="module")
def setup():
    """JAX state, batches, draws, and the JAX step's losses and gradients
    for two batches (full lengths, and lengths near the segment)."""
    parts = jtrain.make_train_step(JCFG, disc_width_div=DIV).parts
    opt = parts["opt"]
    # numpy trees in the JAX layouts (an eager JAX init would take longer
    # than the step's compile)
    params_g = jax.tree_util.tree_map(jnp.asarray, from_jax.random_synthesizer_tree(
        TCFG.model, seed=0))
    params_d = jax.tree_util.tree_map(jnp.asarray, from_jax.random_discriminator_tree(
        "v2", DIV, seed=1))
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params_g=params_g,
                              params_d=params_d, opt_g=opt.init(params_g),
                              opt_d=opt.init(params_d),
                              lr=jnp.asarray(JCFG.train.learning_rate, jnp.float32))

    @jax.jit
    def ref_step(state, batch, rng):
        rng_fwd, _ = jax.random.split(rng)
        y_hat, ids_slice, _, _ = parts["forward_g"](state.params_g, batch, rng_fwd)
        wave_slice = jnn.slice_segments(batch.wave, ids_slice * HOP, SEG * HOP)
        (loss_d, _), d_grads = jax.value_and_grad(parts["d_loss_fn"], has_aux=True)(
            state.params_d, wave_slice, y_hat)
        upd, _ = opt.update(d_grads, jtrain._with_lr(state.opt_d, state.lr), state.params_d)
        params_d = optax.apply_updates(state.params_d, upd)
        (loss_g, aux), g_grads = jax.value_and_grad(parts["g_loss_fn"], has_aux=True)(
            state.params_g, params_d, batch, rng_fwd)
        return dict(loss_d=loss_d, loss_g=loss_g, **aux), d_grads, g_grads, y_hat

    out = {"state": state, "params_g": tree_np(state.params_g),
           "params_d": tree_np(state.params_d)}
    for name, short in (("full", False), ("short", True)):
        b = _batch_np(seed=1, short=short)
        rng = jax.random.PRNGKey(7)
        metrics, d_grads, g_grads, y_hat = ref_step(state, jtrain.Batch(**b), rng)
        out[name] = dict(batch=b, draws=_jax_draws(rng, b["spec_lengths"]),
                         metrics={k: float(v) for k, v in metrics.items()},
                         d_grads=tree_np(d_grads), g_grads=tree_np(g_grads),
                         y_hat=np.asarray(y_hat))
    return out


def _port_state(setup):
    return ttrain.init_state(
        TCFG, from_jax.synthesizer_from_jax(setup["params_g"], TCFG.model, train=True),
        from_jax.discriminator_from_jax(setup["params_d"]), device="cpu",
        disc_width_div=DIV)


def _noise(draws):
    return {k: {kk: torch.tensor(vv) for kk, vv in v.items()} if isinstance(v, dict)
            else torch.tensor(v) for k, v in draws.items()}


@pytest.mark.parametrize("which", ["full", "short"])
def test_train_step_losses_and_grads_match_jax(setup, which):
    ref = setup[which]
    state = _port_state(setup)
    m = ttrain.make_train_step(TCFG, DIV)(
        state, ttrain.Batch(**ref["batch"]).to("cpu"), noise=_noise(ref["draws"]),
        keep_grads=True)
    # each loss term: <= 1e-4 relative
    for k in ("loss_g", "loss_d", "loss_mel", "loss_kl", "loss_fm", "loss_adv"):
        np.testing.assert_allclose(float(m[k]), ref["metrics"][k], rtol=1e-4, err_msg=k)
    # each gradient leaf: <= 1e-3 x max|g| of the leaf (torch_port_util)
    assert_grads_close(m["grads_g"], ttrain.tree_leaves(from_jax.synthesizer_from_jax(
        ref["g_grads"], TCFG.model, train=True)), "G")
    assert_grads_close(m["grads_d"], ttrain.tree_leaves(from_jax.discriminator_from_jax(
        ref["d_grads"])), "D")
    assert state.step == 1


def test_train_forward_y_hat_matches_jax(setup):
    ref = setup["full"]
    params = from_jax.synthesizer_from_jax(setup["params_g"], TCFG.model, train=True)
    b = ref["batch"]
    with torch.no_grad():
        y_hat, ids, _, _, _ = tsyn.train_forward(
            params, TCFG.model, t(b["phone"]), t(b["phone_lengths"], torch.int64),
            t(b["pitch"], torch.int64), t(b["pitchf"]), t(b["spec"]),
            t(b["spec_lengths"], torch.int64), t(b["sid"], torch.int64),
            **_noise(ref["draws"]))
    np.testing.assert_array_equal(n(ids), ref["draws"]["ids_slice"])
    # train_forward y_hat: <= 1e-3 abs
    np.testing.assert_allclose(n(y_hat), ref["y_hat"], atol=1e-3, rtol=0)


def test_posterior_encoder_and_forward_flow_match_jax(setup):
    b = setup["full"]["batch"]
    jp = jax.tree_util.tree_map(jnp.asarray, setup["params_g"])
    tp = from_jax.synthesizer_from_jax(setup["params_g"], TCFG.model, train=True)
    noise = np.random.RandomState(3).randn(B, T, 32).astype(np.float32)
    lengths = np.array([T, 20, 13, 9], np.int32)
    g_np = np.random.RandomState(4).randn(B, 1, 16).astype(np.float32)
    ref = jsyn.posterior_encoder(jp["enc_q"], JCFG.model, jnp.asarray(b["spec"]),
                                 jnp.asarray(lengths), jnp.asarray(g_np), jnp.asarray(noise))
    with torch.no_grad():
        got = tsyn.posterior_encoder(tp["enc_q"], t(b["spec"]), t(lengths, torch.int64),
                                     t(g_np), t(noise))
    # posterior_encoder, forward flow: <= 1e-4 x max(1, |ref|max)
    for name, a, r in zip(("z", "m", "logs", "mask"), got, ref):
        rel_close(n(a), n(r), 1e-4, name)
    ref_f = jsyn.flow(jp["flow"], ref[0], ref[3], jnp.asarray(g_np), reverse=False)
    with torch.no_grad():
        got_f = tsyn.flow(tp["flow"], got[0], got[3], t(g_np), reverse=False)
    rel_close(n(got_f), n(ref_f), 1e-4, "flow")


@pytest.mark.parametrize("n_fft,hop,L", [(256, 64, 64 * 24), (2048, 480, 480 * 36)])
def test_training_spectrograms_match_jax(n_fft, hop, L):
    y = (np.random.RandomState(n_fft).randn(2, L) * 0.3).astype(np.float32)
    ref = jstft.spectrogram(jnp.asarray(y), n_fft=n_fft, hop_length=hop, win_length=n_fft)
    got = tstft.spectrogram(t(y), n_fft=n_fft, hop_length=hop, win_length=n_fft)
    assert got.shape == ref.shape == (2, L // hop, n_fft // 2 + 1)
    # spectrogram / spec_to_mel / mel_spectrogram: <= 1e-4 x max(1, |ref|max)
    rel_close(n(got), n(ref), 1e-4, "spectrogram")
    kw = dict(n_fft=n_fft, sample_rate=16000 if n_fft == 256 else 48000, fmin=0.0,
              fmax=None)
    rel_close(n(tstft.spec_to_mel(got, n_mels=32, **kw)),
               n(jstft.spec_to_mel(ref, n_mels=32, **kw)), 1e-4, "spec_to_mel")
    rel_close(n(tstft.mel_spectrogram(t(y), num_mels=32, hop_length=hop,
                                       win_length=n_fft, **kw)),
               n(jstft.mel_spectrogram(jnp.asarray(y), num_mels=32, hop_length=hop,
                                       win_length=n_fft, **kw)), 1e-4, "mel_spectrogram")


def test_slice_segments_clamps_like_jax():
    """Starts past the end are clamped; negative ones count from the end
    first, as jax.lax.dynamic_slice_in_dim takes them."""
    x = np.arange(2 * 10 * 3, dtype=np.float32).reshape(2, 10, 3)
    for ids in ([0, 7], [-3, 9], [4, 100], [-1, -12]):
        ids = np.array(ids, np.int32)
        ref = jnn.slice_segments(jnp.asarray(x), jnp.asarray(ids), 4)
        got = tnn.slice_segments(t(x), torch.as_tensor(ids), 4)
        np.testing.assert_array_equal(n(got), n(ref))
        ref2 = jnn.slice_segments(jnp.asarray(x[..., 0]), jnp.asarray(ids), 4)
        np.testing.assert_array_equal(
            n(tnn.slice_segments(t(x[..., 0]), torch.as_tensor(ids), 4)), n(ref2))


def test_weight_norm_w_matches_jax():
    rs = np.random.RandomState(5)
    v = rs.randn(5, 1, 4, 6).astype(np.float32)        # JAX (Kh, 1, Cin, Cout)
    g = rs.rand(1, 1, 1, 6).astype(np.float32)
    ref = jnn.weight_norm_w(jnp.asarray(g), jnp.asarray(v))
    got = tnn.weight_norm_w(t(g.transpose(3, 2, 0, 1)), t(v.transpose(3, 2, 0, 1)))
    np.testing.assert_allclose(n(got), n(ref).transpose(3, 2, 0, 1), rtol=1e-6, atol=1e-7)


def test_adamw_matches_optax_adamw():
    """torch.optim.AdamW vs optax.adamw on identical params and gradients
    over 3 steps, lr changing between steps: <= 1e-6 relative."""
    rs = np.random.RandomState(6)
    p0 = rs.randn(7, 5).astype(np.float32)
    grads = [rs.randn(7, 5).astype(np.float32) for _ in range(3)]
    opt = jtrain.make_optimizer(JCFG)
    jp, js = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = t(p0).requires_grad_(True)
    topt = ttrain.make_optimizer({"w": tp}, TCFG)
    lr = JCFG.train.learning_rate
    for g in grads:
        upd, js = opt.update(jnp.asarray(g), jtrain._with_lr(js, jnp.float32(lr)), jp)
        jp = optax.apply_updates(jp, upd)
        ttrain._apply(topt, [tp], [t(g)], lr)
        np.testing.assert_allclose(n(tp), n(jp), rtol=1e-6, atol=1e-9)
        lr *= 0.5


def test_lr_decay():
    state = ttrain.init_state(TCFG, device="cpu", disc_width_div=DIV)
    ttrain.decay_lr(state, TCFG)
    assert state.lr == pytest.approx(TCFG.train.learning_rate * TCFG.train.lr_decay, rel=1e-12)


def _tree_bytes(tree):
    return [n(leaf).tobytes() for leaf in ttrain.tree_leaves(tree)]


def test_exact_resume_is_bitwise(tmp_path):
    """2 steps, save, load into a fresh state, 1 step == 3 steps straight,
    the noise drawn from the state's generator and the lr decayed once
    before the third step."""
    batches = [ttrain.Batch(**_batch_np(seed=s)).to("cpu") for s in (10, 11, 12)]
    step = ttrain.make_train_step(TCFG, DIV)
    straight = ttrain.init_state(TCFG, device="cpu", disc_width_div=DIV, seed=3)
    step(straight, batches[0])
    step(straight, batches[1])
    ttrain.decay_lr(straight, TCFG)
    m_straight = step(straight, batches[2])

    first = ttrain.init_state(TCFG, device="cpu", disc_width_div=DIV, seed=3)
    step(first, batches[0])
    step(first, batches[1])
    ttrain.decay_lr(first, TCFG)
    path = os.path.join(tmp_path, "ckpt.pt")
    tloop.save_checkpoint(first, path, epoch=4)
    resumed = ttrain.init_state(TCFG, device="cpu", disc_width_div=DIV, seed=99)
    assert tloop.load_checkpoint(path, resumed) == 4
    m_resumed = step(resumed, batches[2])

    assert resumed.step == straight.step == 3
    for k in m_straight:
        assert float(m_resumed[k]) == float(m_straight[k]), k
    for key in ("params_g", "params_d"):
        assert _tree_bytes(getattr(resumed, key)) == _tree_bytes(getattr(straight, key))


def test_train_config_rejects_unported_modes():
    """bf16 and remat training are ported: TrainConfig takes both (it
    refused them before they were), and the presets match JAX's."""
    tc = tconfig.TrainConfig(bf16=True, remat=True)
    assert tc.bf16 and tc.remat
    assert tconfig.preset("v2", 48000).train.segment_size == 17280
    from rvc_maker_tpu.config import model_config_to_ckpt_list as jlist
    from rvc_maker_tpu.config import preset as jpreset
    for sr in (32000, 40000, 48000):
        assert (tconfig.model_config_to_ckpt_list(tconfig.preset("v2", sr).model)
                == jlist(jpreset("v2", sr).model))
