"""The port's AudioLDM2 modules (`models/audioldm2.py`,
`models/audioldm2_text.py`) against the JAX package's on the CPU.

The same seeded numpy weights and inputs go through both, at the JAX
tests' tiny sizes; each output within 1e-4 x max(1, |ref|max).  The
weights come from the JAX package's initialisers or from state dicts
keyed as its own tests key them (diffusers-layout UNet / VAE dicts,
transformers CLAP / T5 / GPT2 / SpeechT5 HiFi-GAN models), carried over
by `interop/from_jax.py` `audioldm2_from_jax` or imported by both
packages' importers.  The vocoder's routing is spied on: at a width in
`SUPPORTED_C` a resblock calls `fused_resblock`, at 512 the plain chain.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu.models import audioldm2 as jam
from rvc_maker_tpu.models import audioldm2_text as jat
from rvc_maker_tpu_torch.interop import from_jax
from rvc_maker_tpu_torch.models import audioldm2 as tam
from rvc_maker_tpu_torch.models import audioldm2_text as tat
from rvc_maker_tpu_torch.ops import resblock as rb_ops
from test_audioldm2_unet import CROSS, GROUPS, IN_CH, make_unet_sd
from torch_port_util import n, t, torch_threads, tree_np  # noqa: F401

TOL = 1e-4
# the JAX references, jitted (op by op they take several times as long)
J_UNET = jax.jit(jam.unet_forward, static_argnums=1)
J_VOCODER = jax.jit(jam.vocoder_apply, static_argnums=1)
J_ENCODE = jax.jit(jam.vae_encode_mode, static_argnums=1)
J_DECODE = jax.jit(jam.vae_decode, static_argnums=1)
J_GENERATE = jax.jit(jat.generate_language_model, static_argnums=(1, 4))


def close(got, ref, tol=TOL):
    got, ref = n(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err


def nchw(a):
    """JAX channels-last (B, H, W, C) -> the port's (B, C, H, W)."""
    return t(np.transpose(np.asarray(a), (0, 3, 1, 2)))


def to_nhwc(x):
    return np.transpose(n(x), (0, 2, 3, 1))


# ------------------------------------------------------------ primitives


def test_group_norm_and_timestep_embedding():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 5, 6, 8).astype(np.float32)
    gamma, beta = rs.randn(8).astype(np.float32), rs.randn(8).astype(np.float32)
    ref = jam.group_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), groups=4)
    got = tam.group_norm(nchw(x), t(gamma), t(beta), groups=4)
    close(to_nhwc(got), ref)
    steps = np.array([0, 5, 381, 999], np.int32)
    close(tam.timestep_embedding(torch.as_tensor(steps), 32),
          jam.timestep_embedding(jnp.asarray(steps), 32))


def test_resnet_matches_jax():
    rs = np.random.RandomState(2)
    p = jam._init_resnet(rs, 8, 12, temb_dim=16)
    p["gn1"]["gamma"] = rs.randn(8).astype(np.float32)
    p["gn2"]["beta"] = rs.randn(12).astype(np.float32)
    x = rs.randn(2, 6, 5, 8).astype(np.float32)
    temb = rs.randn(2, 16).astype(np.float32)
    ref = jam._resnet(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(temb),
                      groups=4)
    got = tam._resnet(from_jax._ldm_tree(p), nchw(x), t(temb), groups=4)
    close(to_nhwc(got), ref)


# ----------------------------------------------------------------- VAE


@pytest.fixture(scope="module")
def vae():
    cfg = jam.VAEConfig(block_out_channels=(8, 16), latent_channels=4, layers_per_block=1,
                        norm_groups=4)
    jp = tree_np(jam.init_vae(jax.random.PRNGKey(0), cfg))
    tcfg = tam.VAEConfig(block_out_channels=(8, 16), latent_channels=4, layers_per_block=1,
                         norm_groups=4)
    return cfg, jp, tcfg, from_jax._ldm_tree(jp)


def test_vae_encode_decode_match_jax(vae):
    cfg, jp, tcfg, tp = vae
    x = np.random.RandomState(3).randn(1, 12, 16, 1).astype(np.float32)
    zj = J_ENCODE(jp, cfg, jnp.asarray(x))
    zt = tam.vae_encode_mode(tp, tcfg, nchw(x))
    close(to_nhwc(zt), zj)
    z = np.random.RandomState(4).randn(1, 6, 8, 4).astype(np.float32)
    close(to_nhwc(tam.vae_decode(tp, tcfg, nchw(z))), J_DECODE(jp, cfg, jnp.asarray(z)))


def _vae_sd(rs):
    """A diffusers-keyed tiny VAE state dict (JAX test_vae_importer's)."""
    sd = {}

    def conv(prefix, cin, cout, k=3):
        sd[f"{prefix}.weight"] = rs.randn(cout, cin, k, k).astype(np.float32) * 0.1
        sd[f"{prefix}.bias"] = rs.randn(cout).astype(np.float32) * 0.1

    def gn(prefix, c):
        sd[f"{prefix}.weight"] = 1 + rs.randn(c).astype(np.float32) * 0.1
        sd[f"{prefix}.bias"] = rs.randn(c).astype(np.float32) * 0.1

    def resnet(prefix, cin, cout):
        gn(f"{prefix}.norm1", cin)
        conv(f"{prefix}.conv1", cin, cout)
        gn(f"{prefix}.norm2", cout)
        conv(f"{prefix}.conv2", cout, cout)
        if cin != cout:
            conv(f"{prefix}.conv_shortcut", cin, cout, k=1)

    def attn(prefix, c):
        gn(f"{prefix}.group_norm", c)
        for name in ("to_q", "to_k", "to_v", "to_out.0"):
            sd[f"{prefix}.{name}.weight"] = rs.randn(c, c).astype(np.float32) * 0.1
            sd[f"{prefix}.{name}.bias"] = rs.randn(c).astype(np.float32) * 0.1

    conv("encoder.conv_in", 1, 8)
    resnet("encoder.down_blocks.0.resnets.0", 8, 8)
    conv("encoder.down_blocks.0.downsamplers.0.conv", 8, 8)
    resnet("encoder.down_blocks.1.resnets.0", 8, 16)
    resnet("encoder.mid_block.resnets.0", 16, 16)
    attn("encoder.mid_block.attentions.0", 16)
    resnet("encoder.mid_block.resnets.1", 16, 16)
    gn("encoder.conv_norm_out", 16)
    conv("encoder.conv_out", 16, 8)
    conv("quant_conv", 8, 8, k=1)
    conv("post_quant_conv", 4, 4, k=1)
    conv("decoder.conv_in", 4, 16)
    resnet("decoder.mid_block.resnets.0", 16, 16)
    attn("decoder.mid_block.attentions.0", 16)
    resnet("decoder.mid_block.resnets.1", 16, 16)
    resnet("decoder.up_blocks.0.resnets.0", 16, 16)
    resnet("decoder.up_blocks.0.resnets.1", 16, 16)
    conv("decoder.up_blocks.0.upsamplers.0.conv", 16, 16)
    resnet("decoder.up_blocks.1.resnets.0", 16, 8)
    resnet("decoder.up_blocks.1.resnets.1", 8, 8)
    gn("decoder.conv_norm_out", 8)
    conv("decoder.conv_out", 8, 1)
    return sd


def test_vae_importer_matches_jax(vae):
    cfg, _, tcfg, _ = vae
    sd = _vae_sd(np.random.RandomState(4))
    jp, tp = jam.vae_params_from_state_dict(sd), tam.vae_params_from_state_dict(sd)
    x = np.random.RandomState(5).randn(1, 8, 16, 1).astype(np.float32)
    z = J_ENCODE(jp, cfg, jnp.asarray(x))
    close(to_nhwc(tam.vae_encode_mode(tp, tcfg, nchw(x))), z)
    close(to_nhwc(tam.vae_decode(tp, tcfg, nchw(np.asarray(z)))), J_DECODE(jp, cfg, z))
    del sd["decoder.conv_out.bias"]
    for importer in (jam.vae_params_from_state_dict, tam.vae_params_from_state_dict):
        with pytest.raises(KeyError):
            importer(sd)


# ----------------------------------------------------------------- UNet


def _streams(seed, b=1):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, 5, 12).astype(np.float32), rs.randn(b, 7, 20).astype(np.float32))


def test_unet_forward_matches_jax():
    """JAX init_unet's tree at the JAX stack's tiny config: slots (None,
    12, 20), every block with attention."""
    cfg = jam.UNetConfig(in_channels=4, block_out_channels=(8, 16), layers_per_block=1,
                         n_heads=2, cross_dim=12, cross_dim_1=20, norm_groups=4)
    jp = tree_np(jam.init_unet(jax.random.PRNGKey(1), cfg))
    tcfg = tam.UNetConfig(in_channels=4, block_out_channels=(8, 16), layers_per_block=1,
                          n_heads=2, cross_dim=12, cross_dim_1=20, norm_groups=4)
    tp = from_jax._ldm_tree(jp)
    x = np.random.RandomState(6).randn(2, 6, 8, 4).astype(np.float32)
    eh0, eh1 = _streams(7, b=2)
    steps = np.array([7, 900], np.int32)
    ref = J_UNET(jp, cfg, jnp.asarray(x), jnp.asarray(steps), jnp.asarray(eh0),
                           jnp.asarray(eh1))
    got = tam.unet_forward(tp, tcfg, nchw(x), torch.as_tensor(steps), t(eh0), t(eh1))
    close(to_nhwc(got), ref)


@pytest.mark.parametrize("attn_down,attn_up", [((True, True), (True, True)),
                                               ((False, True), (True, False))],
                         ids=["all-attention", "attention-less-ends"])
def test_unet_importer_routing_matches_jax(attn_down, attn_up):
    """A diffusers-keyed UNet (JAX test_audioldm2_unet's `make_unet_sd`:
    per-slot proj_in as 1x1 conv or linear, head_dim 4) through both
    importers: every key consumed, the same inferred config, the same
    forward; with the real layout's attention-less first down and last
    up blocks, and with each stream silenced in turn."""
    sd = make_unet_sd(np.random.RandomState(0), attn_down=attn_down, attn_up=attn_up)
    jp, jcfg = jam.unet_params_from_state_dict(sd, head_dim=4, norm_groups=GROUPS)
    tp, tcfg = tam.unet_params_from_state_dict(sd, head_dim=4, norm_groups=GROUPS)
    assert tcfg.slot_dims == jcfg.slot_dims == CROSS
    assert (tcfg.block_out_channels, tcfg.layers_per_block, tcfg.in_channels) == (
        jcfg.block_out_channels, jcfg.layers_per_block, jcfg.in_channels)
    assert ("attn" in tp["down"][0]) == attn_down[0] and ("attn" in tp["up"][-1]) == attn_up[-1]
    x = np.random.RandomState(1).randn(1, 8, 4, IN_CH).astype(np.float32)
    eh0, eh1 = _streams(2)
    for zero in (None, 1, 2):
        jq, tq = copy.deepcopy(jp), copy.deepcopy(tp)
        if zero is not None:            # silence one cross slot's attn2 output everywhere
            for tree in (jq, tq):
                layers = [s for side in ("down", "up") for blk in tree[side]
                          for s in blk.get("attn", [])] + [tree["mid"]["attn"]]
                for slots in layers:
                    o = slots[zero]["blocks"][0]["attn2"]["o"]
                    o["w"], o["b"] = o["w"] * 0, o["b"] * 0
        ref = J_UNET(jq, jcfg, jnp.asarray(x), jnp.asarray([100], jnp.int32),
                               jnp.asarray(eh0), jnp.asarray(eh1))
        got = tam.unet_forward(tq, tcfg, nchw(x), torch.tensor([100]), t(eh0), t(eh1))
        close(to_nhwc(got), ref)


def test_unet_importer_errors_match_jax():
    sd = make_unet_sd(np.random.RandomState(3))
    extra = dict(sd, **{"down_blocks.0.attentions.0.bogus_extra": torch.zeros(3)})
    missing = {k: v for k, v in sd.items() if k != "mid_block.resnets.1.conv2.bias"}
    for importer in (jam.unet_params_from_state_dict, tam.unet_params_from_state_dict):
        with pytest.raises(ValueError, match="unconsumed"):
            importer(extra, head_dim=4)
        with pytest.raises(KeyError, match="mid_block.resnets.1.conv2.bias"):
            importer(missing, head_dim=4)


def test_unet_resizes_where_jax_cannot_concatenate():
    """A latent side that is not a multiple of 2**(levels - 1): each
    upsample takes the next skip's size (diffusers' upsample_size), so
    the output has the input's shape; JAX's x2 repeat cannot meet the
    skip there."""
    sd = make_unet_sd(np.random.RandomState(0))
    tp, tcfg = tam.unet_params_from_state_dict(sd, head_dim=4, norm_groups=GROUPS)
    jp, jcfg = jam.unet_params_from_state_dict(sd, head_dim=4, norm_groups=GROUPS)
    x = np.random.RandomState(1).randn(1, 7, 5, IN_CH).astype(np.float32)
    eh0, eh1 = _streams(2)
    got = tam.unet_forward(tp, tcfg, nchw(x), torch.tensor([100]), t(eh0), t(eh1))
    assert got.shape == (1, IN_CH, 7, 5) and torch.isfinite(got).all()
    with pytest.raises(TypeError):
        J_UNET(jp, jcfg, jnp.asarray(x), jnp.asarray([100], jnp.int32), jnp.asarray(eh0),
               jnp.asarray(eh1))


# -------------------------------------------------------------- vocoder


def _speecht5_sd(model_in_dim, ch, rates, kernels, rb_kernels, rb_dils, seed):
    """A transformers SpeechT5HifiGan state dict (JAX test_speecht5_hifigan's
    model), with mean / scale drawn."""
    from transformers import SpeechT5HifiGan, SpeechT5HifiGanConfig

    torch.manual_seed(seed)
    net = SpeechT5HifiGan(SpeechT5HifiGanConfig(
        model_in_dim=model_in_dim, upsample_initial_channel=ch, upsample_rates=list(rates),
        upsample_kernel_sizes=list(kernels), resblock_kernel_sizes=list(rb_kernels),
        resblock_dilation_sizes=[list(d) for d in rb_dils], normalize_before=True)).eval()
    with torch.no_grad():
        net.mean.normal_(0, 0.5)
        net.scale.uniform_(0.5, 2.0)
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def _weight_normed(sd):
    """The same weights in both weight-norm spellings: weight_g / weight_v
    for the resblocks' convs, parametrizations.weight.original0 / 1 for
    the rest."""
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight") and v.dim() == 3:
            prefix = k[:-len(".weight")]
            g = torch.sqrt(torch.sum(v ** 2, dim=(1, 2), keepdim=True))
            names = ((".weight_g", ".weight_v") if prefix.startswith("resblocks") else
                     (".parametrizations.weight.original0", ".parametrizations.weight.original1"))
            out[prefix + names[0]], out[prefix + names[1]] = g, v * 3.0
        else:
            out[k] = v
    return out


VOCODERS = {
    # the JAX test's model: every stage below the kernel's widths
    "narrow": dict(model_in_dim=8, ch=16, rates=(4, 2), kernels=(8, 4), rb_kernels=(3, 5),
                   rb_dils=((1, 3), (1, 3))),
    # a stage at C = 64, on `fused_resblock` (k = 3 / 7, dilations 1 / 3 / 5)
    "kernel-width": dict(model_in_dim=8, ch=128, rates=(2, 2), kernels=(4, 4),
                         rb_kernels=(3, 7), rb_dils=((1, 3, 5), (1, 3, 5))),
}


@pytest.mark.parametrize("name", sorted(VOCODERS))
@pytest.mark.parametrize("spelling", ["plain", "weight-norm"])
def test_vocoder_matches_jax(name, spelling):
    v = VOCODERS[name]
    sd = _speecht5_sd(seed=0, **v)
    if spelling == "weight-norm":
        sd = _weight_normed(sd)
    kw = dict(model_in_dim=v["model_in_dim"], upsample_initial_channel=v["ch"],
              upsample_rates=v["rates"], upsample_kernel_sizes=v["kernels"],
              resblock_kernel_sizes=v["rb_kernels"], resblock_dilation_sizes=v["rb_dils"])
    spec = np.random.RandomState(0).randn(2, 13, v["model_in_dim"]).astype(np.float32)
    ref = J_VOCODER(jam.vocoder_params_from_state_dict(sd), jam.VocoderConfig(**kw),
                    jnp.asarray(spec))
    got = tam.vocoder_apply(tam.vocoder_params_from_state_dict(sd), tam.VocoderConfig(**kw),
                            t(spec))
    close(got, ref)
    # the JAX tree carried over by from_jax gives the same port weights
    jtree = tree_np(jam.vocoder_params_from_state_dict(sd))
    close(tam.vocoder_apply(from_jax._vocoder_from_jax(jtree), tam.VocoderConfig(**kw), t(spec)),
          ref)


@pytest.mark.parametrize("slope", [0.1, 0.2])
def test_vocoder_routes_resblocks_by_width(monkeypatch, slope):
    """At C in SUPPORTED_C (256) each resblock calls `fused_resblock`; at
    C = 512 (the published first stage) and at any slope other than the
    kernel's 0.1, the plain chain.  The output is the same either way."""
    cfg = tam.VocoderConfig(model_in_dim=8, upsample_initial_channel=1024, upsample_rates=(2, 2),
                            upsample_kernel_sizes=(4, 4), resblock_kernel_sizes=(3, 11),
                            resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)), leaky_slope=slope)
    p = from_jax._random_vocoder(from_jax._Draws(0, "cpu"), cfg)
    calls = []
    fused, plain = rb_ops.fused_resblock, rb_ops._resblock
    monkeypatch.setattr(rb_ops, "fused_resblock",
                        lambda x, *a, **kw: calls.append(("fused", x.shape[1])) or fused(x, *a, **kw))
    monkeypatch.setattr(rb_ops, "_resblock",
                        lambda x, *a, **kw: calls.append(("plain", x.shape[1])) or plain(x, *a, **kw))
    spec = t(np.random.RandomState(1).randn(1, 5, 8))
    got = tam.vocoder_apply(p, cfg, spec)
    on_kernel = "fused" if slope == 0.1 else "plain"
    assert calls == [("plain", 512)] * 2 + [(on_kernel, 256)] * 2
    jtree = {"mean": n(p["mean"]), "scale": n(p["scale"]),
             "conv_pre": {"w": n(p["conv_pre"]["w"]).transpose(2, 1, 0), "b": n(p["conv_pre"]["b"])},
             "conv_post": {"w": n(p["conv_post"]["w"]).transpose(2, 1, 0),
                           "b": n(p["conv_post"]["b"])},
             "ups": [{"w": n(u["w"]).transpose(2, 0, 1), "b": n(u["b"])} for u in p["ups"]],
             "resblocks": [{"convs1": [{"w": n(rb["w1"][i]), "b": n(rb["b1"][i])} for i in range(3)],
                            "convs2": [{"w": n(rb["w2"][i]), "b": n(rb["b2"][i])} for i in range(3)]}
                           for rb in p["resblocks"]]}
    jcfg = jam.VocoderConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    close(got, J_VOCODER(jtree, jcfg, jnp.asarray(n(spec))))


# ----------------------------------------------------------------- text


@pytest.fixture(scope="module")
def clap_net():
    from transformers import ClapTextConfig, ClapTextModelWithProjection

    tcfg = ClapTextConfig(vocab_size=120, hidden_size=32, num_hidden_layers=2,
                          num_attention_heads=4, intermediate_size=64,
                          max_position_embeddings=64, projection_dim=16, hidden_act="gelu",
                          projection_hidden_act="relu")
    torch.manual_seed(0)
    return tcfg, ClapTextModelWithProjection(tcfg).eval().state_dict()


def test_clap_text_features_match_jax(clap_net):
    tcfg, sd = clap_net
    kw = dict(vocab_size=120, hidden_size=32, n_layers=2, n_heads=4, intermediate_size=64,
              max_position_embeddings=64, pad_token_id=tcfg.pad_token_id, projection_dim=16)
    rs = np.random.RandomState(0)
    ids = rs.randint(2, 120, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), np.int32)
    mask[1, 6:] = 0
    ids[1, 6:] = tcfg.pad_token_id
    ref = jat.clap_get_text_features(jat.clap_params_from_state_dict(sd),
                                     jat.ClapTextConfig(**kw), jnp.asarray(ids),
                                     jnp.asarray(mask))
    got = tat.clap_get_text_features(tat.clap_params_from_state_dict(sd),
                                     tat.ClapTextConfig(**kw), torch.as_tensor(ids),
                                     torch.as_tensor(mask))
    close(got, ref)


def test_t5_encoder_matches_jax():
    from transformers import T5Config, T5EncoderModel

    torch.manual_seed(1)
    sd = T5EncoderModel(T5Config(
        vocab_size=100, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_heads=4,
        relative_attention_num_buckets=8, relative_attention_max_distance=20,
        feed_forward_proj="gated-gelu", dropout_rate=0.0)).eval().state_dict()
    kw = dict(vocab_size=100, d_model=32, d_kv=8, d_ff=48, n_layers=2, n_heads=4,
              rel_buckets=8, rel_max_distance=20)
    rs = np.random.RandomState(1)
    ids = rs.randint(0, 100, (2, 23)).astype(np.int32)
    mask = np.ones((2, 23), np.int32)
    mask[0, 17:] = 0
    ref = jat.t5_encode(jat.t5_params_from_state_dict(sd), jat.T5Config(**kw),
                        jnp.asarray(ids), jnp.asarray(mask))
    got = tat.t5_encode(tat.t5_params_from_state_dict(sd), tat.T5Config(**kw),
                        torch.as_tensor(ids), torch.as_tensor(mask))
    close(got, ref)


def test_gpt2_generate_and_projection_match_jax():
    """generate_language_model (a full GPT2 pass per new token) on the
    projection's output, masks included, as the stack chains them."""
    from transformers import GPT2Config, GPT2Model

    torch.manual_seed(2)
    gsd = GPT2Model(GPT2Config(vocab_size=90, n_positions=64, n_embd=32, n_layer=2, n_head=4,
                               resid_pdrop=0.0, embd_pdrop=0.0,
                               attn_pdrop=0.0)).eval().state_dict()
    rs = np.random.RandomState(4)
    psd = {"projection.weight": rs.randn(32, 16).astype(np.float32) * 0.2,
           "projection.bias": rs.randn(32).astype(np.float32) * 0.1,
           "projection_1.weight": rs.randn(32, 12).astype(np.float32) * 0.2,
           "projection_1.bias": rs.randn(32).astype(np.float32) * 0.1,
           **{k: rs.randn(32).astype(np.float32) for k in ("sos_embed", "eos_embed",
                                                           "sos_embed_1", "eos_embed_1")}}
    h0 = rs.randn(2, 1, 16).astype(np.float32)
    h1 = rs.randn(2, 6, 12).astype(np.float32)
    m0, m1 = np.ones((2, 1), np.int32), np.ones((2, 6), np.int32)
    m1[1, 4:] = 0
    jh, jm = jat.projection_forward(jat.projection_params_from_state_dict(psd), jnp.asarray(h0),
                                    jnp.asarray(h1), jnp.asarray(m0), jnp.asarray(m1))
    th, tm = tat.projection_forward(tat.projection_params_from_state_dict(psd), t(h0), t(h1),
                                    torch.as_tensor(m0), torch.as_tensor(m1))
    close(th, jh)
    np.testing.assert_array_equal(n(tm), np.asarray(jm))
    cfg = dict(n_embd=32, n_layers=2, n_heads=4)
    ref = J_GENERATE(jat.gpt2_params_from_state_dict(gsd), jat.GPT2Config(**cfg), jh, jm, 5)
    got = tat.generate_language_model(tat.gpt2_params_from_state_dict(gsd),
                                      tat.GPT2Config(**cfg), th, tm, max_new_tokens=5)
    close(got, ref)
