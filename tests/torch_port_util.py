"""Shared helpers for the PyTorch port's tests (tests/test_torch_*.py).

Data passes between JAX and PyTorch as numpy arrays.  Torch's CPU
threads are capped so that the xdist workers do not oversubscribe.
"""

import math

import numpy as np
import pytest
import torch

# the reference-layout writers, for the tests that import them from here
from rvc_maker_tpu_torch.interop.from_jax import hubert_state_dict, rmvpe_state_dict  # noqa: F401

TORCH_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(prev)


def rel_close(got, ref, rel, what=""):
    """max |got - ref| <= rel * max(1, |ref|max)."""
    scale = max(1.0, float(np.abs(np.asarray(ref)).max()))
    err = float(np.abs(np.asarray(got) - np.asarray(ref)).max())
    assert err <= rel * scale, (what, err, rel * scale)


def assert_grads_close(got, ref, what="", rel=1e-3):
    """Each gradient leaf within rel (1e-3) x the max |g| of its reference.  A
    leaf whose exact gradient is zero (the attention key bias: softmax
    does not see a shift shared by all keys) holds rounding noise on both
    sides, below 1e-6 x the largest gradient of the tree; there both
    must stay below that floor."""
    got, ref = [n(g) for g in got], [n(g) for g in ref]
    assert len(got) == len(ref), what
    floor = 1e-6 * max(float(np.abs(r).max()) for r in ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape, (what, i)
        if np.abs(r).max() < floor:
            assert np.abs(g).max() < floor, (what, i, r.shape)
            continue
        err = float(np.abs(g - r).max())
        assert err <= rel * np.abs(r).max(), (what, i, r.shape, err)


def grads_rel_err(got, ref) -> float:
    """The largest leaf error over the max |g| of its reference leaf, the
    measure `assert_grads_close` bounds, over the leaves above its floor."""
    got, ref = [n(g) for g in got], [n(g) for g in ref]
    floor = 1e-6 * max(float(np.abs(r).max()) for r in ref)
    return max(float(np.abs(g - r).max() / np.abs(r).max())
               for g, r in zip(got, ref) if np.abs(r).max() >= floor)


BF16_ULPS = 4     # a bf16 kernel vs a bf16 reference: max abs <= 4 ulps of |ref|max


def bf16_ulp(v: float) -> float:
    """The spacing of bf16 values (8 significant bits) at |v|."""
    return 2.0 ** (math.frexp(float(v))[1] - 8)


def t(a, dtype=torch.float32):
    """numpy (or JAX array) -> CPU tensor."""
    return torch.as_tensor(np.array(a), dtype=dtype)


def n(x):
    """tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def resblock_params(seed, k, C, D):
    """One resblock's convs in the JAX layout ((k, Cin, Cout) weights)."""
    rs = np.random.RandomState(seed)
    scale = 0.5 / (k * C) ** 0.5

    def conv():
        return {"w": (rs.randn(k, C, C) * scale).astype(np.float32),
                "b": (rs.randn(C) * 0.1).astype(np.float32)}

    return {"convs1": [conv() for _ in range(D)], "convs2": [conv() for _ in range(D)]}


def packed_resblock(p):
    """resblock_params -> the port kernel's (w1, b1, w2, b2) CPU tensors."""
    from rvc_maker_tpu_torch.interop.from_jax import _conv
    from rvc_maker_tpu_torch.interop.pth import pack_resblock

    rb = pack_resblock([_conv(c) for c in p["convs1"]], [_conv(c) for c in p["convs2"]])
    return rb["w1"], rb["b1"], rb["w2"], rb["b2"]


def resblock_x(T, C, b=2):
    """(b, T, C) activations, the JAX package's layout."""
    return (np.random.RandomState(T).randn(b, T, C) * 0.3).astype(np.float32)


def tree_np(tree):
    """A JAX param tree -> the same tree of numpy arrays."""
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def jax_noise(b, p_len, inter, upp, seed=0, dtype=None):
    """The z / sine noise the JAX ConvertPipeline draws for one call
    (pipelines/convert.py `_synth_raw`: split(PRNGKey(seed)), normals in
    the compute dtype).  dtype=None: fp32 numpy arrays; a JAX dtype
    (jnp.bfloat16): the draws in that dtype, as torch tensors of it."""
    import jax

    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    if dtype is None:
        return (np.array(jax.random.normal(k1, (b, p_len, inter))),
                np.array(jax.random.normal(k2, (b, p_len * upp, 1))))
    return (jax_to_torch(jax.random.normal(k1, (b, p_len, inter), dtype)),
            jax_to_torch(jax.random.normal(k2, (b, p_len * upp, 1), dtype)))


def jax_to_torch(a):
    """A JAX array -> a CPU tensor of the same dtype (bf16 included, by
    way of fp32, which holds every bf16 value exactly)."""
    import jax.numpy as jnp

    if a.dtype == jnp.bfloat16:
        return torch.as_tensor(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.as_tensor(np.array(a))


def jax_decoder_noise(cfg, b, t, seed=0, dtype=None):
    """The z noise and decoder noise that the JAX package's `infer_any`
    draws from PRNGKey(seed) (models/synthesizer.py:551-593), laid out
    as the port's `decoder_noise`: numpy arrays; with a JAX dtype
    (jnp.bfloat16) the normals are drawn in it, as JAX's bf16 mode draws
    them, and returned as torch tensors of it (`rand_ini` stays fp32)."""
    import jax

    k_z, k_src, k_ini, k_adain = jax.random.split(jax.random.PRNGKey(seed), 4)
    out = np.array if dtype is None else jax_to_torch

    def normal(key, shape):
        return out(jax.random.normal(key, shape) if dtype is None
                   else jax.random.normal(key, shape, dtype))

    z = normal(k_z, (b, t, cfg.inter_channels))
    n = t * cfg.upp
    if not cfg.use_f0:
        return z, {}
    if cfg.vocoder in ("MRF HiFi-GAN", "MRF-HiFi-GAN"):
        return z, {"source": normal(k_src, (b, n, 9)),
                   "rand_ini": np.array(jax.random.uniform(k_ini, (b, 9)).at[:, 0].set(0.0))}
    if cfg.vocoder == "RefineGAN":
        keys = iter(jax.random.split(k_adain, 6 * len(cfg.upsample_rates)))
        adain, ch, tc = [], cfg.upsample_initial_channel, t
        for rate in cfg.upsample_rates:
            ch, tc = ch // 2, tc * rate
            adain.append([tuple(normal(next(keys), (b, tc, ch)) for _ in range(2))
                          for _ in range(3)])
        return z, {"source": normal(k_src, (b, n, 1)),
                   "rand_ini": np.zeros((b, 1), np.float32), "adain": adain}
    return z, {"sine": normal(k_src, (b, n, 1))}


def voice(seconds, f0=180.0, seed=0):
    """A harmonic 16 kHz test tone with vibrato and a little noise."""
    tt = np.arange(int(16000 * seconds)) / 16000
    phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.05 * np.sin(2 * np.pi * 3 * tt))) / 16000
    x = sum(0.3 / h * np.sin(h * phase) for h in (1, 2, 3))
    return (x + 0.01 * np.random.RandomState(seed).randn(len(tt))).astype(np.float32)


def run_cli_convert(tmp_path, sd, jcfg, hubert_tree, rmvpe_tree, index_path, seconds=1.5):
    """The port's `cli convert` on the CPU, on a .pth holding the state
    dict `sd` (as the JAX exporter writes it) with jcfg's config list, a
    reference-layout rmvpe.pt, a fairseq-layout HuBERT checkpoint and
    `index_path`.  Returns (output waveform, its rate)."""
    from rvc_maker_tpu.config import model_config_to_ckpt_list
    from rvc_maker_tpu_torch import cli
    from rvc_maker_tpu_torch.utils.audio import read_wav, save_wav

    torch.save({"weight": {k: torch.from_numpy(np.ascontiguousarray(v)).half()
                           for k, v in sd.items()},
                "config": model_config_to_ckpt_list(jcfg), "f0": int(jcfg.use_f0),
                "version": "v2", "vocoder": jcfg.vocoder}, tmp_path / "voice.pth")
    torch.save(rmvpe_state_dict(rmvpe_tree, np.random.RandomState(0)), tmp_path / "rmvpe.pt")
    torch.save({"model": hubert_state_dict(hubert_tree)}, tmp_path / "hubert.pt")
    save_wav(str(tmp_path / "in.wav"), voice(seconds), 16000)
    rc = cli.main(["convert", "--input", str(tmp_path / "in.wav"),
                   "--output", str(tmp_path / "out.wav"),
                   "--model", str(tmp_path / "voice.pth"),
                   "--rmvpe-path", str(tmp_path / "rmvpe.pt"),
                   "--hubert-path", str(tmp_path / "hubert.pt"),
                   "--index", str(index_path), "--index-rate", "0.5", "--device", "cpu"])
    assert rc == 0
    return read_wav(str(tmp_path / "out.wav"))


def fcpe_state_dict(tree, legacy: bool, weight_norm: bool = True):
    """A reference FCPE state dict (CFNaiveMelPE keys, or PCmer's with
    legacy=True) from a JAX-layout tree (interop.from_jax.random_fcpe_tree);
    the output projection split into weight_g / weight_v."""
    stem = "stack" if legacy else "input_stack"
    layers = "decoder._layers" if legacy else "net.encoder_layers"
    out_name = "dense_out" if legacy else "output_proj"
    sd = {}

    def conv(prefix, p):
        sd[f"{prefix}.weight"] = np.transpose(p["w"], (2, 1, 0))
        sd[f"{prefix}.bias"] = p["b"]

    def lin(prefix, p, pointwise=False):
        w = np.asarray(p["w"]).T
        sd[f"{prefix}.weight"] = w[:, :, None] if pointwise else w
        sd[f"{prefix}.bias"] = p["b"]

    def ln(prefix, p):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = p["gamma"], p["beta"]

    conv(f"{stem}.0", tree["in_conv1"])
    ln(f"{stem}.1", tree["in_gn"])
    conv(f"{stem}.3", tree["in_conv2"])
    ln("norm", tree["norm"])
    w = np.asarray(tree["out"]["w"]).T
    if weight_norm:
        sd[f"{out_name}.weight_g"] = np.sqrt(np.square(w).sum(axis=1, keepdims=True))
        sd[f"{out_name}.weight_v"] = w
        sd[f"{out_name}.bias"] = tree["out"]["b"]
    else:
        lin(out_name, tree["out"])
    sd["cent_table"] = tree["cent_table"]
    for i, lp in enumerate(tree["layers"]):
        p = f"{layers}.{i}"
        ln(f"{p}.norm", lp["ln"])
        if lp.get("attn") is not None:
            for k, m in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("o", "to_out")):
                lin(f"{p}.attn.{m}", lp["attn"][k])
            sd[f"{p}.attn.fast_attention.projection_matrix"] = lp["attn"]["projection"]
        c = lp["conv"]
        ln(f"{p}.conformer.net.0", c["ln"])
        lin(f"{p}.conformer.net.2", c["pw1"], pointwise=True)
        conv(f"{p}.conformer.net.4.conv", c["dw"])
        lin(f"{p}.conformer.net.6", c["pw2"], pointwise=True)
    return {k: torch.as_tensor(np.ascontiguousarray(v, np.float32)) for k, v in sd.items()}


def crepe_state_dict(tree, rs):
    """A reference Crepe state dict (4-D conv weights, conv{i}_BN.*) from a
    JAX-layout tree's convs and classifier, with random BN statistics."""
    sd = {}
    for i, c in enumerate(tree["convs"], start=1):
        sd[f"conv{i}.weight"] = np.transpose(c["w"], (2, 1, 0))[:, :, :, None]
        sd[f"conv{i}.bias"] = c["b"]
        n_out = c["w"].shape[-1]
        sd[f"conv{i}_BN.weight"] = rs.uniform(0.5, 1.5, n_out)
        sd[f"conv{i}_BN.bias"] = rs.randn(n_out) * 0.1
        sd[f"conv{i}_BN.running_mean"] = rs.randn(n_out) * 0.1
        sd[f"conv{i}_BN.running_var"] = rs.uniform(0.5, 2.0, n_out)
    sd["classifier.weight"] = np.asarray(tree["classifier"]["w"]).T
    sd["classifier.bias"] = tree["classifier"]["b"]
    return {k: torch.as_tensor(np.ascontiguousarray(v, np.float32)) for k, v in sd.items()}


def hf_hubert_state_dict(tree):
    """A transformers HubertModel state dict ("hubert."-prefixed, as a
    HubertModel with a final_proj head saves it) from a JAX-layout tree."""
    import re

    out = {"hubert.masked_spec_embed": torch.zeros(768)}
    for k, v in hubert_state_dict(tree).items():
        if k.startswith("final_proj."):
            out[k] = v
            continue
        k = re.sub(r"feature_extractor\.conv_layers\.(\d+)\.0\.",
                   r"feature_extractor.conv_layers.\1.conv.", k)
        k = k.replace("feature_extractor.conv_layers.0.2.",
                      "feature_extractor.conv_layers.0.layer_norm.")
        k = re.sub(r"^layer_norm\.", "feature_projection.layer_norm.", k)
        k = k.replace("post_extract_proj.", "feature_projection.projection.")
        k = k.replace("encoder.pos_conv.0.", "encoder.pos_conv_embed.conv.")
        k = re.sub(r"\.self_attn_layer_norm\.", ".layer_norm.", k)
        k = k.replace(".self_attn.", ".attention.")
        k = k.replace(".fc1.", ".feed_forward.intermediate_dense.")
        k = k.replace(".fc2.", ".feed_forward.output_dense.")
        out["hubert." + k] = v
    return out


def patch_jax_noise(monkeypatch):
    """Every call of the port's `ConvertPipeline.convert_utterance` gets
    the noise the JAX pipeline draws for each chunk (PRNGKey(0)), so that
    a port command line's output can be held against the JAX one's."""
    from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline

    orig = ConvertPipeline.convert_utterance

    def convert_utterance(self, *a, **kw):
        cfg = self.cfg

        def noise_fn(b, p_len):
            z, s = jax_noise(b, p_len, cfg.inter_channels, cfg.upp)
            return torch.as_tensor(z), {"sine": torch.as_tensor(s)}

        kw["noise_fn"] = noise_fn          # convert_split passes its own (None)
        return orig(self, *a, **kw)

    monkeypatch.setattr(ConvertPipeline, "convert_utterance", convert_utterance)


def jax_edit_noise(w0, steps: int, seed: int = 0) -> torch.Tensor:
    """The marginals' noise JAX `edit` draws for the latent w0 (the port's
    layout): normal(PRNGKey(seed), (steps, *JAX's latent shape)), a
    (Z, t, f) latent being JAX's (t, f, Z), in the port's layout."""
    import jax

    shape = tuple(w0.shape) if w0.dim() == 2 else (w0.shape[1], w0.shape[2], w0.shape[0])
    a = np.array(jax.random.normal(jax.random.PRNGKey(seed), (steps, *shape)))
    return torch.as_tensor(a if w0.dim() == 2 else a.transpose(0, 3, 1, 2).copy())


def patch_jax_edit_noise(monkeypatch):
    """Every call of the port's `edit/pipeline.py` `edit` with a stack and
    no noise gets the noise JAX's `edit` draws for that input (its seed),
    so that a command line's or a route's output can be held against the
    JAX one's."""
    from rvc_maker_tpu_torch.edit import pipeline as tep
    from rvc_maker_tpu_torch.utils.audio import load_audio

    orig = tep.edit

    def edit(input_path, output_path, *, stack=None, steps=50, seed=0, noise=None, **kw):
        if noise is None and stack is not None:
            w0 = stack.vae_encode(stack.get_mel(load_audio(input_path, tep.MEL_SR))[0])
            noise = jax_edit_noise(w0, steps, seed)
        return orig(input_path, output_path, stack=stack, steps=steps, seed=seed, noise=noise,
                    **kw)

    monkeypatch.setattr(tep, "edit", edit)


def write_voice_files(d, jcfg, seed=0, scale=20.0):
    """A voice the JAX exporter writes (fp16 .pth of a seeded random tree,
    its decode scaled up so that 1e-3 is a tight bound on the waveform),
    a reference-layout rmvpe.pt of a narrow RMVPE and a 2-layer fairseq
    HuBERT .pt, under directory `d`.  Returns their paths by name; the
    JAX fairseq loader needs its N_LAYERS set to 2 to read the HuBERT."""
    import jax
    import jax.numpy as jnp

    from rvc_maker_tpu.config import RVCConfig as JaxRVCConfig
    from rvc_maker_tpu.interop.torch_export import export_synthesizer_pth
    from rvc_maker_tpu_torch.interop import from_jax

    tree = from_jax.random_synthesizer_tree(jcfg, seed=seed)
    for u in tree["dec"]["ups"]:
        u["w"] *= scale
    tree["dec"]["conv_post"]["w"] *= scale
    files = dict(model=str(d / f"voice{seed}.pth"), rmvpe=str(d / "rmvpe.pt"),
                 embedder=str(d / "hubert.pt"))
    export_synthesizer_pth(jax.tree_util.tree_map(jnp.asarray, tree),
                           JaxRVCConfig(version="v2", model=jcfg), files["model"])
    torch.save(rmvpe_state_dict(from_jax.random_rmvpe_tree(
        seed=2, widths=(4, 8, 16, 32, 64), inter_width=128), np.random.RandomState(0)),
        files["rmvpe"])
    torch.save({"model": hubert_state_dict(from_jax.random_hubert_tree(seed=1, n_layers=2))},
               files["embedder"])
    return files
