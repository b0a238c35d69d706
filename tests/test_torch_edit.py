"""The port's audio editing (`edit/ddpm_inversion.py`, `edit/pipeline.py`,
`edit/stack.py`, `interop/safetensors_io.py`, `cli edit`) against the JAX
package's on the CPU.

JAX draws the inversion's marginal noise with `jax.random.normal`, which
torch cannot reproduce, so the port is given JAX's draw
(`torch_port_util.jax_edit_noise`).  The scheduler tables are equal; the
noise maps, the marginals and the edited latent agree within 1e-4 x
max|ref|; `edit` end to end writes the JAX waveform within 1e-3, with
the toy stack and with JAX's tiny AudioLDM2 stack carried over by
`interop/from_jax.py` `audioldm2_from_jax`; the reconstruction identity
holds at JAX's atol 5e-4.  The safetensors reader is held against the
`safetensors` package (which only this test imports).
"""

import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu import cli as jax_cli
from rvc_maker_tpu.edit import ddpm_inversion as jdi
from rvc_maker_tpu.edit import pipeline as jep
from rvc_maker_tpu.edit import stack as jst
from rvc_maker_tpu_torch import cli as tcli
from rvc_maker_tpu_torch.edit import ddpm_inversion as tdi
from rvc_maker_tpu_torch.edit import pipeline as tep
from rvc_maker_tpu_torch.edit import stack as tst
from rvc_maker_tpu_torch.errors import BadRequest
from rvc_maker_tpu_torch.interop import from_jax
from rvc_maker_tpu_torch.interop import safetensors_io as sio
from rvc_maker_tpu_torch.utils.audio import load_audio, read_wav, save_wav
from torch_port_util import (jax_edit_noise, n, patch_jax_edit_noise, t,  # noqa: F401
                             torch_threads, tree_np)

TOL = 1e-4
WAVE_TOL = 1e-3


def rel_err(got, ref) -> float:
    got, ref = n(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))


def tone(seconds=0.5, hz=220.0, sr=16000):
    tt = np.arange(int(seconds * sr)) / sr
    return (0.4 * np.sin(2 * np.pi * hz * tt)).astype(np.float32)


def wave_err(a: str, b: str) -> float:
    (x, sx), (y, sy) = read_wav(a), read_wav(b)
    assert sx == sy and x.shape == y.shape and x.ndim == 2 and x.shape[1] == 2, (x.shape, y.shape)
    return float(np.abs(x - y).max())


# --------------------------------------------------------- the scheduler


@pytest.mark.parametrize("steps,kw", [(50, {}), (10, {}), (7, dict(beta_schedule="linear")),
                                      (20, dict(beta_schedule="squaredcos_cap_v2",
                                                set_alpha_to_one=True))])
def test_make_schedule_tables_equal(steps, kw):
    j, p = jdi.make_schedule(steps, **kw), tdi.make_schedule(steps, **kw)
    np.testing.assert_array_equal(p.alphas_cumprod, j.alphas_cumprod)
    np.testing.assert_array_equal(p.timesteps, j.timesteps)
    assert (p.num_train_timesteps, p.num_inference_steps, p.final_alpha_cumprod) == (
        j.num_train_timesteps, j.num_inference_steps, j.final_alpha_cumprod)
    for s in j.timesteps:
        s = int(s)
        assert (p.alpha_prod(s), p.alpha_prod_prev(s), p.variance(s)) == (
            j.alpha_prod(s), j.alpha_prod_prev(s), j.variance(s))


# --------------------------------------------------------- the inversion


def _toy_eps(w, lib):
    """JAX test_ddpm_inversion's toy denoiser, in jnp or torch."""
    def eps_fn(x, step):
        base = lib.tanh(x @ w) * 0.5 + 1e-3 * step / 1000.0
        return base, base + 0.1 * lib.sin(x)
    return eps_fn


@pytest.mark.parametrize("numerical_fix,zero_first", [(False, False), (True, True),
                                                      (False, True)])
def test_inversion_matches_jax_with_its_noise(numerical_fix, zero_first):
    """inversion_forward's zs and xts, then inversion_reverse under another
    denoiser (the edit) and under the same one, from JAX's draw."""
    s = jdi.make_schedule(10)
    rs = np.random.RandomState(2)
    w, w2 = (rs.randn(16, 16).astype(np.float32) * 0.2 for _ in range(2))
    x0 = rs.randn(3, 16).astype(np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, (10, 3, 16)))
    np.testing.assert_allclose(n(tdi.sample_xts_from_x0(t(noise), t(x0), tdi.make_schedule(10))),
                               np.asarray(jdi.sample_xts_from_x0(key, jnp.asarray(x0), s)),
                               rtol=0, atol=1e-6)
    kw = dict(cfg_scale=3.5, etas=1.0, numerical_fix=numerical_fix, zero_first=zero_first)
    jx, jz, jxs = jdi.inversion_forward(_toy_eps(jnp.asarray(w), jnp), jnp.asarray(x0), s,
                                        rng=key, **kw)
    px, pz, pxs = tdi.inversion_forward(_toy_eps(t(w), torch), t(x0), tdi.make_schedule(10),
                                        rng=t(noise), **kw)
    for got, ref in ((px, jx), (pz, jz), (pxs, jxs)):
        assert rel_err(got, ref) <= TOL
    for wr, tstart in ((w2, 7), (w, 10), (w, 4)):
        ref = jdi.inversion_reverse(_toy_eps(jnp.asarray(wr), jnp), jxs, jz, s, tstart=tstart,
                                    cfg_scale=12.0, etas=1.0)
        got = tdi.inversion_reverse(_toy_eps(t(wr), torch), pxs, pz, tdi.make_schedule(10),
                                    tstart=tstart, cfg_scale=12.0, etas=1.0)
        assert rel_err(got, ref) <= TOL


def test_low_pass_filter_equal():
    x = np.random.RandomState(0).randn(4000).astype(np.float32)
    np.testing.assert_array_equal(tdi.low_pass_filter(x, 4000, 16000),
                                  jdi.low_pass_filter(x, 4000, 16000))


# ------------------------------------------------------------ the stacks


@pytest.fixture(scope="module")
def stacks():
    """JAX's AudioLDM2Stack.init_tiny and the port's stack on its weights."""
    js = jst.AudioLDM2Stack.init_tiny(jax.random.PRNGKey(0))
    ps = tst.AudioLDM2Stack(vae_cfg=js.vae_cfg, unet_cfg=js.unet_cfg, voc_cfg=js.voc_cfg,
                            clap_cfg=js.clap_cfg, t5_cfg=js.t5_cfg, gpt2_cfg=js.gpt2_cfg,
                            params=from_jax.audioldm2_from_jax(tree_np(js.params)),
                            tokenize=js.tokenize, max_new_tokens=js.max_new_tokens,
                            n_mels=js.n_mels, device="cpu")
    return js, ps


def test_stack_mel_and_latent_match_jax(stacks):
    """get_mel and vae_encode with its front pad to a multiple of 4 (the
    text streams, the UNet, vae_decode and the vocoder are held in
    test_torch_audioldm2.py, and all of them by the edit below)."""
    js, ps = stacks
    audio = np.random.RandomState(7).randn(4100).astype(np.float32) * 0.1
    jm, _ = js.get_mel(audio)
    pm, _ = ps.get_mel(audio)
    assert jm.shape[0] % 4 and rel_err(pm, jm) <= TOL
    assert rel_err(ps.vae_encode(pm).permute(1, 2, 0), js.vae_encode(jm)) <= TOL


def test_stack_inversion_reconstruction_identity(stacks):
    """JAX's anchor on the port: with etas = 1 and numerical_fix the stored
    (xts, zs) reproduce the input latent when reversed under the same
    prompt and scale (atol 5e-4)."""
    _, ps = stacks
    audio = np.random.RandomState(7).randn(4000).astype(np.float32) * 0.1
    w0 = ps.vae_encode(ps.get_mel(audio)[0])
    sched, eps_fn = tdi.make_schedule(4), ps.make_eps_fn("drums", 2.0)
    _, zs, wts = tdi.inversion_forward(eps_fn, w0, sched, cfg_scale=2.0, etas=1.0,
                                       rng=torch.Generator().manual_seed(1), numerical_fix=True,
                                       zero_first=False)
    w_rec = tdi.inversion_reverse(eps_fn, wts, zs, sched, tstart=4, cfg_scale=2.0, etas=1.0)
    np.testing.assert_allclose(n(w_rec), n(w0), atol=5e-4)


def _jit_jax_stack(monkeypatch):
    """The JAX stack's models jitted (its UNet is already): op by op they
    take most of a minute."""
    from rvc_maker_tpu.models import audioldm2 as jam
    from rvc_maker_tpu.models import audioldm2_text as jat

    for mod, name, static in ((jat, "clap_get_text_features", (1,)), (jat, "t5_encode", (1,)),
                              (jat, "gpt2_forward_embeds", (1,)), (jam, "vae_encode_mode", (1,)),
                              (jam, "vae_decode", (1,)), (jam, "vocoder_apply", (1,))):
        monkeypatch.setattr(mod, name, jax.jit(getattr(mod, name), static_argnums=static))


def test_edit_with_audioldm2_stack_matches_jax(stacks, tmp_path, monkeypatch):
    """JAX test_full_stack_edit_end_to_end's call on both packages: the
    written waveform within 1e-3."""
    js, ps = stacks
    _jit_jax_stack(monkeypatch)
    src = str(tmp_path / "in.wav")
    save_wav(src, (0.3 * np.sin(2 * np.pi * 220 * np.arange(16000) / 16000))[:, None], 16000)
    kw = dict(source_prompt="piano", target_prompt="violin", steps=4, t_start=50, sr=16000)
    ref = jep.edit(src, str(tmp_path / "jax.wav"), stack=js, **kw)
    w0 = ps.vae_encode(ps.get_mel(load_audio(src, 16000))[0])
    got = tep.edit(src, str(tmp_path / "port.wav"), stack=ps, device="cpu",
                   noise=jax_edit_noise(w0, 4), **kw)
    err = wave_err(got, ref)
    print(f"audioldm2 tiny stack edit, port vs JAX: {err:.3e}")
    assert err <= WAVE_TOL, err


@pytest.mark.parametrize("sr", [16000, 44100])
def test_edit_with_toy_stack_matches_jax(tmp_path, sr):
    src = str(tmp_path / "in.wav")
    save_wav(src, tone(), 16000, subtype="float32")
    kw = dict(steps=8, t_start=50, sr=sr, source_prompt="a", target_prompt="b")
    ref = jep.edit(src, str(tmp_path / "jax.wav"), stack=jep.ToyMelStack(), **kw)
    stack = tep.ToyMelStack(device="cpu")
    w0 = stack.vae_encode(stack.get_mel(tone())[0])
    got = tep.edit(src, str(tmp_path / "port.wav"), stack=stack, device="cpu",
                   noise=jax_edit_noise(w0, 8), **kw)
    assert read_wav(got)[1] == sr
    assert wave_err(got, ref) <= WAVE_TOL


def test_edit_t_start_zero_is_reconstruction(tmp_path):
    """t_start = 0 starts the reverse chain at x0: the output is the mel ->
    Griffin-Lim reconstruction of the input, whatever the noise."""
    src = str(tmp_path / "in.wav")
    save_wav(src, tone(), 16000, subtype="float32")
    stack = tep.ToyMelStack(device="cpu")
    got, _ = read_wav(tep.edit(src, str(tmp_path / "rec.wav"), stack=stack, steps=8, t_start=0,
                               sr=16000, device="cpu"))
    direct = tdi.low_pass_filter(stack.decode_to_mel(stack.get_mel(tone())[0]), 7500.0, 16000)
    m = min(len(direct), got.shape[0])
    np.testing.assert_allclose(got[:m, 0], direct[:m], atol=2e-4)


def test_cli_edit_toy_stack_matches_jax_cli(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    save_wav("in.wav", tone(), 16000, subtype="float32")
    args = ["edit", "--input-path", "in.wav", "--toy-stack", "--steps", "8", "--t-start", "50",
            "--source-prompt", "a", "--target-prompt", "b"]
    jax_cli.main(args + ["--output-path", "jax.wav"])
    patch_jax_edit_noise(monkeypatch)
    assert tcli.main(args + ["--output-path", "port.wav", "--device", "cpu"]) == 0
    assert "port.wav" in capsys.readouterr().out
    assert read_wav("port.wav")[1] == 44100
    assert wave_err("port.wav", "jax.wav") <= WAVE_TOL


def test_edit_on_the_card_raises_without_one(tmp_path):
    assert not torch.cuda.is_available()
    src = str(tmp_path / "in.wav")
    save_wav(src, tone(), 16000)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tep.edit(src, str(tmp_path / "out.wav"), stack=None, device="cuda")
    for make in (lambda: tep.ToyMelStack(), lambda: tst.AudioLDM2Stack.init_tiny(0)):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tcli.main(["edit", "--input-path", src, "--toy-stack"])


def test_stack_loaders_raise_as_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for load in (lambda m: jep.load_audioldm2_stack(m),
                 lambda m: tep.load_audioldm2_stack(m, device="cpu")):
        with pytest.raises(RuntimeError, match="download-gated"):
            load("audioldm2-music")
        with pytest.raises(ValueError, match="unknown audioldm2 model"):
            load("not-a-model")


# ------------------------------------------------------ safetensors files


def test_safetensors_reader_matches_package(tmp_path):
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    sd = {"f32": torch.randn(3, 4, generator=g), "f16": torch.randn(5, generator=g).half(),
          "bf16": torch.randn(2, 3, generator=g).bfloat16(),
          "i64": torch.arange(-3, 4), "i32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
          "i16": torch.arange(4, dtype=torch.int16), "i8": torch.arange(-2, 2, dtype=torch.int8),
          "u8": torch.arange(7, dtype=torch.uint8), "empty": torch.zeros(0, 3),
          "scalar": torch.tensor(2.5)}
    path = str(tmp_path / "x.safetensors")
    save_file(sd, path, metadata={"format": "pt"})
    got = sio.load_file(path)
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape and torch.equal(got[k], v), k


def _raw_file(path, header: dict, data: bytes):
    h = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h + data)
    return path


def test_safetensors_reader_refuses_what_it_cannot_read(tmp_path):
    from safetensors.numpy import save_file

    path = str(tmp_path / "f64.safetensors")
    save_file({"a": np.ones(3)}, path)                         # F64
    with pytest.raises(BadRequest, match="dtype 'F64'"):
        sio.load_file(path)
    bad = {"overrun": ({"a": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}, b"\0" * 8),
           "size": ({"a": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}}, b"\0" * 8),
           "bool": ({"a": {"dtype": "BOOL", "shape": [2], "data_offsets": [0, 2]}}, b"\0" * 2)}
    for name, (header, data) in bad.items():
        with pytest.raises(BadRequest):
            sio.load_file(_raw_file(str(tmp_path / f"{name}.safetensors"), header, data))
    with open(tmp_path / "long.safetensors", "wb") as f:
        f.write(struct.pack("<Q", 1000) + b"{}")
    with pytest.raises(BadRequest, match="overruns the file"):
        sio.load_file(str(tmp_path / "long.safetensors"))


def _write_checkpoint_dir(root):
    """A diffusers-layout AudioLDM2 directory, JAX
    test_load_components_from_synthetic_checkpoint_dir's: transformers
    models saved for CLAP / T5 / GPT2 / the vocoder, diffusers-keyed
    tensors for the VAE, the projection and the UNet."""
    from safetensors.numpy import save_file
    from test_audioldm2_unet import make_unet_sd
    from test_torch_audioldm2 import _vae_sd
    from transformers import (ClapTextConfig, ClapTextModelWithProjection, GPT2Config,
                              GPT2Model, SpeechT5HifiGan, SpeechT5HifiGanConfig, T5Config,
                              T5EncoderModel)

    def save(sub, sd, name="model.safetensors"):
        (root / sub).mkdir(parents=True, exist_ok=True)
        save_file({k: np.ascontiguousarray(v.detach().numpy() if hasattr(v, "detach") else v)
                   for k, v in sd.items()}, str(root / sub / name))

    torch.manual_seed(0)
    save("text_encoder", ClapTextModelWithProjection(ClapTextConfig(
        vocab_size=80, hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=24, max_position_embeddings=32, projection_dim=8)).state_dict())
    save("text_encoder_2", T5EncoderModel(T5Config(
        vocab_size=80, d_model=16, d_kv=4, d_ff=24, num_layers=1, num_heads=4,
        relative_attention_num_buckets=8, relative_attention_max_distance=16,
        feed_forward_proj="gated-gelu", dropout_rate=0.0)).state_dict())
    save("language_model", GPT2Model(GPT2Config(vocab_size=80, n_positions=32, n_embd=16,
                                                n_layer=1, n_head=2)).state_dict())
    save("vocoder", SpeechT5HifiGan(SpeechT5HifiGanConfig(
        model_in_dim=8, upsample_initial_channel=16, upsample_rates=[4],
        upsample_kernel_sizes=[8], resblock_kernel_sizes=[3],
        resblock_dilation_sizes=[[1, 3]])).state_dict(), "diffusion_pytorch_model.safetensors")
    rs = np.random.RandomState(0)
    save("projection_model", {
        "projection.weight": rs.randn(16, 8).astype(np.float32),
        "projection.bias": rs.randn(16).astype(np.float32),
        "projection_1.weight": rs.randn(16, 16).astype(np.float32),
        "projection_1.bias": rs.randn(16).astype(np.float32),
        **{k: rs.randn(16).astype(np.float32)
           for k in ("sos_embed", "eos_embed", "sos_embed_1", "eos_embed_1")}})
    save("vae", _vae_sd(rs), "diffusion_pytorch_model.safetensors")
    save("unet", make_unet_sd(np.random.RandomState(7)), "diffusion_pytorch_model.safetensors")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_load_components_from_dir_matches_jax(tmp_path):
    """Every tree the port reads through its safetensors reader equals
    JAX's (read through the `safetensors` package) carried over to the
    port's layouts, leaf for leaf; the UNet's inferred config is JAX's.
    load_from_dir then raises NotImplementedError, as JAX's does."""
    _write_checkpoint_dir(tmp_path)
    jc = jst.load_components_from_dir(str(tmp_path))
    pc = tst.load_components_from_dir(str(tmp_path))
    assert set(pc) == set(jc)
    assert pc["unet_cfg"].slot_dims == jc["unet_cfg"].slot_dims == (None, 12, 20)
    want = from_jax.audioldm2_from_jax({k: tree_np(v) for k, v in jc.items() if k != "unet_cfg"})
    for name, tree in want.items():
        got = dict(_leaves(pc[name]))
        ref = dict(_leaves(tree))
        assert set(got) == set(ref), name
        for k, v in ref.items():
            assert torch.equal(got[k], v), (name, k)
    for load in (lambda: jst.AudioLDM2Stack.load_from_dir(str(tmp_path)),
                 lambda: tst.AudioLDM2Stack.load_from_dir(str(tmp_path), device="cpu")):
        with pytest.raises(NotImplementedError):
            load()
