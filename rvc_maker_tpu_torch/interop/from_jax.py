"""Carry parameter trees of the JAX package over to the port.

The trees come in as nested dicts/lists of numpy arrays in the JAX
package's layouts (for example `jax.tree_util.tree_map(np.asarray,
params)`); nothing here imports JAX.  Layout rules (the JAX package's
interop/torch_import.py:15-19):
  * conv   (K, Cin, Cout) -> (Cout, Cin, K)
  * convT  (K, Cin, Cout) -> (Cin, Cout, K)
  * linear (Cin, Cout)    -> (Cout, Cin)
  * resblock convs -> packed (D, K, Cin, Cout) / (D, C) for the kernel
  * discriminator weight-norm pairs: v (K, Cin, Cout) -> (Cout, Cin, K),
    v (Kh, 1, Cin, Cout) -> (Cout, Cin, Kh, 1); g likewise
  * RMVPE conv (Kh, Kw, Cin, Cout) -> (Cout, Cin, Kh, Kw); its decoder
    convT is stored pre-flipped in JAX and is un-flipped here.

The `random_*_tree` functions draw numpy trees in the same JAX layouts
from a seed, at any width (the v2-48k preset for a full-width run), so
a random full-size model needs neither JAX nor a checkpoint;
`rmvpe_state_dict` and `hubert_state_dict` write such trees in the
reference checkpoints' layouts (rmvpe.pt, a fairseq HuBERT .pt), so the
model can also be served from files.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import ModelConfig
from ..models import discriminator as disc_mod
from ..models import hubert as hubert_mod
from ..models.rmvpe import N_CLASS, make_bigru
from ..models.synthesizer import _stage_paddings, decoder_kind
from ..models.vocoders import MRF_HARMONICS
from .pth import pack_resblock


def _t(a) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(np.asarray(a, np.float32)))


def _lin(p) -> dict:
    out = {"w": _t(np.asarray(p["w"]).T)}
    if p.get("b") is not None:
        out["b"] = _t(p["b"])
    return out


def _conv(p) -> dict:
    out = {"w": _t(np.transpose(np.asarray(p["w"]), (2, 1, 0)))}
    if p.get("b") is not None:
        out["b"] = _t(p["b"])
    return out


def _convt(p) -> dict:
    return {"w": _t(np.transpose(np.asarray(p["w"]), (1, 2, 0))), "b": _t(p["b"])}


def _ln(p) -> dict:
    return {"gamma": _t(p["gamma"]), "beta": _t(p["beta"])}


def _wavenet(p) -> dict:
    out = {"in_layers": [_conv(c) for c in p["in_layers"]],
           "res_skip": [_lin(c) for c in p["res_skip"]]}
    if "cond" in p:
        out["cond"] = _lin(p["cond"])
    return out


def synthesizer_from_jax(tree, cfg: ModelConfig, *, train: bool = False) -> dict:
    """JAX synthesizer params -> the port's tree: the inference tree, or
    with train=True the training tree, which adds the posterior encoder
    `enc_q`.  Also maps a JAX gradient tree onto the port's layouts."""
    enc = tree["enc_p"]
    layers = []
    for lp in enc["encoder"]["layers"]:
        a = lp["attn"]
        layers.append({
            "attn": {"q": _lin(a["q"]), "k": _lin(a["k"]), "v": _lin(a["v"]),
                     "o": _lin(a["o"]), "emb_rel_k": _t(a["emb_rel_k"]),
                     "emb_rel_v": _t(a["emb_rel_v"])},
            "norm1": _ln(lp["norm1"]),
            "ffn": {"conv1": _conv(lp["ffn"]["conv1"]),
                    "conv2": _conv(lp["ffn"]["conv2"])},
            "norm2": _ln(lp["norm2"]),
        })
    enc_p = {"emb_phone": _lin(enc["emb_phone"]), "encoder": {"layers": layers},
             "proj": _lin(enc["proj"])}
    if "emb_pitch" in enc:
        enc_p["emb_pitch"] = {"w": _t(enc["emb_pitch"]["w"])}
    flow = {"layers": [{"pre": _lin(lp["pre"]), "enc": _wavenet(lp["enc"]),
                        "post": _lin(lp["post"])}
                       for lp in tree["flow"]["layers"]]}
    out = {"enc_p": enc_p, "flow": flow, "dec": _decoder_from_jax(tree["dec"], cfg),
           "emb_g": {"w": _t(tree["emb_g"]["w"])}}
    if train:
        q = tree["enc_q"]
        out["enc_q"] = {"pre": _lin(q["pre"]), "enc": _wavenet(q["enc"]),
                        "proj": _lin(q["proj"])}
    return out


def _decoder_from_jax(d, cfg: ModelConfig) -> dict:
    """The decoder tree `decoder_kind(cfg)` names.  The NSF, plain and
    MRF resblocks are packed for the kernel (MRF's `mrfs[i][j].layers`
    stage by stage); RefineGAN keeps torch-layout convs."""
    kind = decoder_kind(cfg)
    if kind == "refinegan":
        dec = {"source": {"merge": _lin(d["source"]["merge"])},
               "pre_conv": _conv(d["pre_conv"]), "mel_conv": _conv(d["mel_conv"]),
               "downsample_blocks": [_conv(c) for c in d["downsample_blocks"]],
               "upsample_conv_blocks": [
                   {"input_conv": _conv(blk["input_conv"]),
                    "blocks": [{"adain1": {"weight": _t(b["adain1"]["weight"])},
                                "res": {k: [_conv(c) for c in b["res"][k]]
                                        for k in ("convs1", "convs2")},
                                "adain2": {"weight": _t(b["adain2"]["weight"])}}
                               for b in blk["blocks"]]}
                   for blk in d["upsample_conv_blocks"]],
               "conv_post": _conv(d["conv_post"])}
    else:
        if kind == "mrf":
            rbs = [([lp["conv1"] for lp in blk["layers"]], [lp["conv2"] for lp in blk["layers"]])
                   for stage in d["mrfs"] for blk in stage]
        else:
            rbs = [(rb["convs1"], rb["convs2"]) for rb in d["resblocks"]]
        dec = {"conv_pre": _conv(d["conv_pre"]), "ups": [_convt(u) for u in d["ups"]]}
        if kind != "plain":
            dec["noise_convs"] = [_conv(c) for c in d["noise_convs"]]
            dec["source"] = {"l_linear": _lin(d["source"]["l_linear"])}
        dec["resblocks"] = [pack_resblock([_conv(c) for c in c1], [_conv(c) for c in c2])
                            for c1, c2 in rbs]
        dec["conv_post"] = _conv(d["conv_post"])
    if "cond" in d:
        dec["cond"] = _lin(d["cond"])
    return dec


def _wn(p, axes) -> dict:
    return {"g": _t(np.transpose(np.asarray(p["g"]), axes)),
            "v": _t(np.transpose(np.asarray(p["v"]), axes)), "b": _t(p["b"])}


def discriminator_from_jax(tree) -> dict:
    """JAX discriminator params (live weight norm, channels-last) -> the
    port's tree in torch layouts.  Also maps a JAX gradient tree."""
    s = tree["s"]
    p1d, p2d = (2, 1, 0), (3, 2, 0, 1)
    return {"s": {"convs": [_wn(c, p1d) for c in s["convs"]],
                  "post": _wn(s["post"], p1d)},
            "p": [{"convs": [_wn(c, p2d) for c in dp["convs"]],
                   "post": _wn(dp["post"], p2d)} for dp in tree["p"]]}


def hubert_from_jax(tree) -> dict:
    """JAX HuBERT params (layer leaves stacked on a leading axis) -> the
    port's tree with one dict per layer."""
    out = {
        "frontend": {"convs": [{"w": _t(np.transpose(np.asarray(c["w"]), (2, 1, 0)))}
                               for c in tree["frontend"]["convs"]],
                     "gn": _ln(tree["frontend"]["gn"])},
        "ln_feats": _ln(tree["ln_feats"]),
        "post_proj": _lin(tree["post_proj"]),
        "pos_conv": _conv(tree["pos_conv"]),
        "ln_pre": _ln(tree["ln_pre"]),
    }
    st = tree["layers"]
    n = np.asarray(st["fc1"]["w"]).shape[0]

    def pick(d, i):
        return {k: (pick(v, i) if isinstance(v, dict) else np.asarray(v)[i])
                for k, v in d.items()}

    out["layers"] = []
    for i in range(n):
        lp = pick(st, i)
        out["layers"].append({
            "attn": {k: _lin(lp["attn"][k]) for k in ("q", "k", "v", "o")},
            "ln1": _ln(lp["ln1"]), "fc1": _lin(lp["fc1"]),
            "fc2": _lin(lp["fc2"]), "ln2": _ln(lp["ln2"]),
        })
    if "final_proj" in tree:
        out["final_proj"] = _lin(tree["final_proj"])
    return out


def _conv2d(p) -> dict:
    out = {"w": _t(np.transpose(np.asarray(p["w"]), (3, 2, 0, 1)))}
    if p.get("b") is not None:
        out["b"] = _t(p["b"])
    return out


def _bn(p) -> dict:
    return {"scale": _t(p["scale"]), "shift": _t(p["shift"])}


def _rmvpe_block(p) -> dict:
    out = {"conv1": _conv2d(p["conv1"]), "bn1": _bn(p["bn1"]),
           "conv2": _conv2d(p["conv2"]), "bn2": _bn(p["bn2"])}
    if "shortcut" in p:
        out["shortcut"] = _conv2d(p["shortcut"])
    return out


def rmvpe_from_jax(tree) -> dict:
    """JAX RMVPE params (BN folded, HWIO convs, pre-flipped convT) -> the
    port's tree (NCHW weights, torch ConvTranspose2d layout, nn.GRU)."""
    def level(lp):
        return {"blocks": [_rmvpe_block(b) for b in lp["blocks"]]}

    dec = []
    for lp in tree["decoder"]:
        w = np.flip(np.asarray(lp["convt"]["w"]), axis=(0, 1))   # un-flip
        dec.append({"convt": {"w": _t(np.transpose(w, (2, 3, 0, 1)))},
                    "bn": _bn(lp["bn"]), **level(lp)})
    return {
        "in_bn": _bn(tree["in_bn"]),
        "encoder": [level(lp) for lp in tree["encoder"]],
        "intermediate": [level(lp) for lp in tree["intermediate"]],
        "decoder": dec,
        "cnn": _conv2d(tree["cnn"]),
        "gru": make_bigru({k: np.asarray(v, np.float32) for k, v in tree["gru"].items()}),
        "fc": {"w": _t(np.asarray(tree["fc"]["w"]).T), "b": _t(tree["fc"]["b"])},
    }


# ---------------------------------------------------------------------------
# random trees in the JAX layouts (numpy, from a seed)
# ---------------------------------------------------------------------------

def random_synthesizer_tree(cfg: ModelConfig, seed: int = 0) -> dict:
    """Synthesizer params drawn like the JAX package's init_params
    (torch default bounds; normal(0, 0.01) for the decoder's ups and
    resblock convs), in its layouts, with the decoder `decoder_kind(cfg)`
    names (the f0-less plain decoder, or MRF-HiFi-GAN and RefineGAN as
    vocoders.py mrf_init_params / refinegan_init_params draw them).  The
    NSF draws do not depend on the kind."""
    rs = np.random.RandomState(seed)

    def uni(shape, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        return rs.uniform(-bound, bound, shape).astype(np.float32)

    def conv(k, cin, cout):
        return {"w": uni((k, cin, cout), cin * k), "b": uni((cout,), cin * k)}

    def lin(cin, cout):
        return {"w": uni((cin, cout), cin), "b": uni((cout,), cin)}

    def normal(shape, std):
        return (rs.standard_normal(shape) * std).astype(np.float32)

    def ln(c):
        return {"gamma": np.ones((c,), np.float32), "beta": np.zeros((c,), np.float32)}

    h, inter = cfg.hidden_channels, cfg.inter_channels
    k_ch = h // cfg.n_heads
    w = 2 * cfg.rel_attn_window_size + 1
    layers = [{
        "attn": {"q": lin(h, h), "k": lin(h, h), "v": lin(h, h), "o": lin(h, h),
                 "emb_rel_k": normal((1, w, k_ch), k_ch ** -0.5),
                 "emb_rel_v": normal((1, w, k_ch), k_ch ** -0.5)},
        "norm1": ln(h),
        "ffn": {"conv1": conv(cfg.kernel_size, h, cfg.filter_channels),
                "conv2": conv(cfg.kernel_size, cfg.filter_channels, h)},
        "norm2": ln(h),
    } for _ in range(cfg.n_layers)]
    enc_p = {"emb_phone": lin(cfg.text_enc_hidden_dim, h),
             "encoder": {"layers": layers}, "proj": lin(h, 2 * inter),
             "emb_pitch": {"w": normal((256, h), 1.0)}}

    def wavenet(n_layers):
        return {"in_layers": [conv(5, h, 2 * h) for _ in range(n_layers)],
                "res_skip": [lin(h, h if i == n_layers - 1 else 2 * h)
                             for i in range(n_layers)],
                "cond": lin(cfg.gin_channels, 2 * h * n_layers)}

    flow = {"layers": [{"pre": lin(inter // 2, h), "enc": wavenet(3),
                        "post": {"w": normal((h, inter // 2), 0.01),
                                 "b": np.zeros((inter // 2,), np.float32)}}
                       for _ in range(4)]}
    uic = cfg.upsample_initial_channel
    ups, noise_convs, resblocks = [], [], []
    for i, st in enumerate(_stage_paddings(cfg)):
        cin, cout = uic // (2 ** i), uic // (2 ** (i + 1))
        ups.append({"w": normal((st["k"], cin, cout), 0.01),
                    "b": np.zeros((cout,), np.float32)})
        noise_convs.append(conv(st["noise_kernel"], 1, cout))
        for ks, ds in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            resblocks.append({
                "convs1": [{"w": normal((ks, cout, cout), 0.01),
                            "b": np.zeros((cout,), np.float32)} for _ in ds],
                "convs2": [{"w": normal((ks, cout, cout), 0.01),
                            "b": np.zeros((cout,), np.float32)} for _ in ds]})
    c_last = uic // 2 ** len(ups)
    dec = {"conv_pre": conv(7, inter, uic), "cond": lin(cfg.gin_channels, uic),
           "ups": ups, "noise_convs": noise_convs, "resblocks": resblocks,
           "conv_post": {"w": normal((7, c_last, 1), 0.01)},
           "source": {"l_linear": lin(1, 1)}}
    emb_g = {"w": normal((cfg.spk_embed_dim, cfg.gin_channels), 1.0)}
    enc_q = {"pre": lin(cfg.spec_channels, h), "enc": wavenet(16),
             "proj": lin(h, 2 * inter)}
    kind = decoder_kind(cfg)
    if not cfg.use_f0:                 # init_params :767, :823
        del enc_p["emb_pitch"], dec["noise_convs"], dec["source"]
    elif kind == "mrf":                # vocoders.py mrf_init_params
        nk = len(cfg.resblock_kernel_sizes)
        dec["source"] = {"l_linear": lin(MRF_HARMONICS + 1, 1)}
        dec["conv_post"] = conv(7, c_last, 1)
        dec["mrfs"] = [[{"layers": [{"conv1": c1, "conv2": c2}
                                    for c1, c2 in zip(rb["convs1"], rb["convs2"])]}
                        for rb in resblocks[i * nk:(i + 1) * nk]]
                       for i in range(len(ups))]
        del dec["resblocks"]
    elif kind == "refinegan":          # vocoders.py refinegan_init_params
        dec = {"source": {"merge": {"w": normal((1, 1), 0.5)}},
               "pre_conv": conv(7, 1, uic // 2),
               "mel_conv": {"w": normal((7, inter, uic // 2), 0.01),
                            "b": np.zeros((uic // 2,), np.float32)},
               "cond": lin(cfg.gin_channels, uic // 2),
               "downsample_blocks": [], "upsample_conv_blocks": []}
        ch = uic
        for i, st in enumerate(_stage_paddings(cfg)):
            dec["downsample_blocks"].append(conv(st["noise_kernel"], 1, uic // 2 ** (i + 2)))
            new = ch // 2
            ones = np.ones((new,), np.float32)
            dec["upsample_conv_blocks"].append({
                "input_conv": {"w": normal((7, ch + ch // 4, new), 0.01),
                               "b": np.zeros((new,), np.float32)},
                "blocks": [{"adain1": {"weight": ones.copy()},
                            "res": {k: [conv(ks, new, new) for _ in range(3)]
                                    for k in ("convs1", "convs2")},
                            "adain2": {"weight": ones.copy()}} for ks in (3, 7, 11)]})
            ch = new
        dec["conv_post"] = {"w": normal((7, ch, 1), 0.01)}
    return {"enc_p": enc_p, "enc_q": enc_q, "flow": flow, "dec": dec,
            "emb_g": emb_g}


def random_discriminator_tree(version: str = "v2", width_div: int = 1,
                              seed: int = 0) -> dict:
    """Discriminator params drawn like the JAX package's init_params
    (torch's default conv bounds, g = ||v||), in its layouts."""
    rs = np.random.RandomState(seed)

    def wn(shape_v):
        bound = 1.0 / math.sqrt(math.prod(shape_v[:-1]))
        v = rs.uniform(-bound, bound, shape_v).astype(np.float32)
        g = np.sqrt(np.sum(np.square(v), axis=tuple(range(len(shape_v) - 1)),
                           keepdims=True))
        return {"g": g, "v": v,
                "b": rs.uniform(-bound, bound, (shape_v[-1],)).astype(np.float32)}

    specs = disc_mod.s_convs(width_div)
    pch = disc_mod.p_channels(width_div)
    return {"s": {"convs": [wn((k, cin // g, cout)) for cin, cout, k, _, g, _ in specs],
                  "post": wn((3, specs[-1][1], 1))},
            "p": [{"convs": [wn((5, 1, cin, cout)) for cin, cout in pch],
                   "post": wn((3, 1, pch[-1][1], 1))}
                  for _ in disc_mod.periods_for(version)]}


def random_hubert_tree(seed: int = 0, n_layers: int = hubert_mod.N_LAYERS) -> dict:
    """HuBERT params drawn like the JAX package's init_params (layer
    leaves stacked on a leading axis), in its layouts."""
    rs = np.random.RandomState(seed)
    e, f = hubert_mod.EMBED_DIM, hubert_mod.FFN_DIM

    def lin(cin, cout, n=None):
        shape = (cin, cout) if n is None else (n, cin, cout)
        bound = 1.0 / math.sqrt(cin)
        return {"w": rs.uniform(-bound, bound, shape).astype(np.float32),
                "b": np.zeros(shape[:-2] + (cout,), np.float32)}

    def ln(c, n=None):
        shape = (c,) if n is None else (n, c)
        return {"gamma": np.ones(shape, np.float32), "beta": np.zeros(shape, np.float32)}

    convs, cin = [], 1
    for dim, k, _ in hubert_mod.CONV_LAYERS:
        convs.append({"w": (rs.standard_normal((k, cin, dim))
                            / math.sqrt(k * cin)).astype(np.float32)})
        cin = dim
    g = hubert_mod.POS_CONV_GROUPS
    pos_w = (rs.standard_normal((hubert_mod.POS_CONV_K, e // g, e))
             * math.sqrt(4.0 / (hubert_mod.POS_CONV_K * e))).astype(np.float32)
    return {
        "frontend": {"convs": convs, "gn": ln(512)},
        "ln_feats": ln(512), "post_proj": lin(512, e),
        "pos_conv": {"w": pos_w, "b": np.zeros((e,), np.float32)},
        "ln_pre": ln(e),
        "layers": {"attn": {k: lin(e, e, n_layers) for k in ("q", "k", "v", "o")},
                   "ln1": ln(e, n_layers), "fc1": lin(e, f, n_layers),
                   "fc2": lin(f, e, n_layers), "ln2": ln(e, n_layers)},
        "final_proj": lin(e, 256),
    }


def random_rmvpe_tree(seed: int = 1234, widths=(16, 32, 64, 128, 256),
                      inter_width: int = 512) -> dict:
    """RMVPE params with the real architecture, drawn as the JAX bench
    draws them (bench.py `_random_rmvpe`), in the JAX layouts (HWIO
    convs, pre-flipped convT).  Narrower `widths` keep the structure
    for small tests."""
    rs = np.random.RandomState(seed)

    def conv(cin, cout, k=3):
        return {"w": (rs.standard_normal((k, k, cin, cout))
                      / np.sqrt(k * k * cin)).astype(np.float32)}

    def bn(c):
        return {"scale": np.ones((c,), np.float32), "shift": np.zeros((c,), np.float32)}

    def block(cin, cout):
        p = {"conv1": conv(cin, cout), "bn1": bn(cout),
             "conv2": conv(cout, cout), "bn2": bn(cout)}
        if cin != cout:
            p["shortcut"] = {"w": conv(cin, cout, 1)["w"],
                             "b": np.zeros((cout,), np.float32)}
        return p

    def level(cin, cout):
        return {"blocks": [block(cin, cout)] + [block(cout, cout) for _ in range(3)]}

    chans = [1, *widths]
    p = {"in_bn": bn(1),
         "encoder": [level(chans[i], chans[i + 1]) for i in range(len(widths))],
         "intermediate": [level(widths[-1], inter_width)]
         + [level(inter_width, inter_width) for _ in range(3)],
         "decoder": []}
    dec_chans = [inter_width, *reversed(widths)]
    for cin, cout in zip(dec_chans[:-1], dec_chans[1:]):
        p["decoder"].append({"convt": conv(cin, cout), "bn": bn(cout),
                             "blocks": [block(cout * 2, cout)]
                             + [block(cout, cout) for _ in range(3)]})
    p["cnn"] = {"w": conv(widths[0], 3)["w"], "b": np.zeros((3,), np.float32)}
    hdim = 256

    def mat(*shape):
        return (rs.standard_normal(shape) * 0.05).astype(np.float32)

    p["gru"] = {"w_ih": mat(3 * hdim, 384), "w_hh": mat(3 * hdim, hdim),
                "b_ih": np.zeros((3 * hdim,), np.float32),
                "b_hh": np.zeros((3 * hdim,), np.float32),
                "w_ih_r": mat(3 * hdim, 384), "w_hh_r": mat(3 * hdim, hdim),
                "b_ih_r": np.zeros((3 * hdim,), np.float32),
                "b_hh_r": np.zeros((3 * hdim,), np.float32)}
    p["fc"] = {"w": mat(2 * hdim, N_CLASS), "b": np.zeros((N_CLASS,), np.float32)}
    return p


def fcpe_from_jax(tree) -> dict:
    """JAX FCPE params (channels-last convs, (Cin, Cout) linears) -> the
    port's tree; a layer's "attn" stays None where the tree has none."""
    def attn(a):
        if a is None:
            return None
        return {**{k: _lin(a[k]) for k in ("q", "k", "v", "o")},
                "projection": _t(a["projection"])}

    return {"in_conv1": _conv(tree["in_conv1"]), "in_gn": _ln(tree["in_gn"]),
            "in_conv2": _conv(tree["in_conv2"]), "norm": _ln(tree["norm"]),
            "out": _lin(tree["out"]), "cent_table": _t(tree["cent_table"]),
            "layers": [{"ln": _ln(lp["ln"]), "attn": attn(lp.get("attn")),
                        "conv": {"ln": _ln(lp["conv"]["ln"]), "pw1": _lin(lp["conv"]["pw1"]),
                                 "dw": _conv(lp["conv"]["dw"]),
                                 "pw2": _lin(lp["conv"]["pw2"])}}
                       for lp in tree["layers"]]}


def crepe_from_jax(tree) -> dict:
    """JAX CREPE params (BatchNorm folded) -> the port's tree."""
    return {"convs": [_conv(c) for c in tree["convs"]],
            "bns": [{"scale": _t(b["scale"]), "shift": _t(b["shift"])} for b in tree["bns"]],
            "classifier": _lin(tree["classifier"])}


def random_fcpe_tree(seed: int = 0, hidden: int = 512, n_layers: int = 6,
                     legacy: bool = False) -> dict:
    """FCPE params in the JAX layouts from a seed (torch's default bounds),
    128 mels in and 360 bins out.  legacy=False: the current conv-only
    layers (CFNaiveMelPE, fcpe.pt's defaults: 512 wide, 6 layers);
    legacy=True: PCmer layers, each with FAVOR+ attention of 8 heads of 64
    and a int(64 ln 64) x 64 projection (fcpe_legacy.pt's defaults: 12
    layers).  The conformer's depthwise conv runs on 2 x hidden channels,
    its first pointwise conv gives 4 x hidden for the GLU."""
    from ..models.fcpe import cent_table

    n_mels, out_dims, n_heads, dim_head = 128, 360, 8, 64
    rs = np.random.RandomState(seed)

    def uni(shape, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        return rs.uniform(-bound, bound, shape).astype(np.float32)

    def lin(cin, cout):
        return {"w": uni((cin, cout), cin), "b": uni((cout,), cin)}

    def conv(k, cin, cout, groups=1):
        fan = k * cin // groups
        return {"w": uni((k, cin // groups, cout), fan), "b": uni((cout,), fan)}

    def ln(c):
        return {"gamma": rs.uniform(0.8, 1.2, c).astype(np.float32),
                "beta": rs.uniform(-0.1, 0.1, c).astype(np.float32)}

    inner = n_heads * dim_head
    n_features = int(dim_head * math.log(dim_head))
    layers = []
    for _ in range(n_layers):
        attn = None
        if legacy:
            attn = {"q": lin(hidden, inner), "k": lin(hidden, inner), "v": lin(hidden, inner),
                    "o": lin(inner, hidden),
                    "projection": rs.standard_normal((n_features, dim_head)).astype(np.float32)}
        layers.append({"ln": ln(hidden), "attn": attn,
                       "conv": {"ln": ln(hidden), "pw1": lin(hidden, 4 * hidden),
                                "dw": conv(31, 2 * hidden, 2 * hidden, groups=2 * hidden),
                                "pw2": lin(2 * hidden, hidden)}})
    return {"in_conv1": conv(3, n_mels, hidden), "in_gn": ln(hidden),
            "in_conv2": conv(3, hidden, hidden), "layers": layers, "norm": ln(hidden),
            "out": lin(hidden, out_dims), "cent_table": cent_table(out_dims)}


def random_crepe_tree(seed: int = 0, capacity: str = "full") -> dict:
    """CREPE params of `capacity` in the JAX layouts (BatchNorm folded into
    scale / shift) from a seed, with torch's default conv bounds."""
    from ..models.crepe import CAPACITIES, KERNELS, PITCH_BINS

    rs = np.random.RandomState(seed)
    ins, outs, n_in = CAPACITIES[capacity]

    def uni(shape, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        return rs.uniform(-bound, bound, shape).astype(np.float32)

    return {"convs": [{"w": uni((k, cin, cout), k * cin), "b": uni((cout,), k * cin)}
                      for k, cin, cout in zip(KERNELS, ins, outs)],
            "bns": [{"scale": rs.uniform(0.5, 1.5, c).astype(np.float32),
                     "shift": rs.uniform(-0.2, 0.2, c).astype(np.float32)} for c in outs],
            "classifier": {"w": uni((n_in, PITCH_BINS), n_in),
                           "b": uni((PITCH_BINS,), n_in)}}


def rmvpe_state_dict(tree, rs):
    """A JAX-layout RMVPE tree as the reference rmvpe.pt's E2E state dict
    (`models.rmvpe.load_rmvpe_pt` reads it back), with BatchNorm
    statistics drawn from the numpy RandomState `rs`."""
    sd = {}

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = rs.uniform(0.5, 1.5, c)
        sd[f"{prefix}.bias"] = rs.randn(c) * 0.1
        sd[f"{prefix}.running_mean"] = rs.randn(c) * 0.1
        sd[f"{prefix}.running_var"] = rs.uniform(0.5, 2.0, c)

    def conv(prefix, p):
        sd[f"{prefix}.weight"] = np.transpose(p["w"], (3, 2, 0, 1))
        if "b" in p:
            sd[f"{prefix}.bias"] = p["b"]

    def block(prefix, p):
        conv(f"{prefix}.conv.0", p["conv1"])
        bn(f"{prefix}.conv.1", p["conv1"]["w"].shape[-1])
        conv(f"{prefix}.conv.3", p["conv2"])
        bn(f"{prefix}.conv.4", p["conv2"]["w"].shape[-1])
        if "shortcut" in p:
            conv(f"{prefix}.shortcut", p["shortcut"])

    bn("unet.encoder.bn", 1)
    for part in ("encoder", "intermediate"):
        for i, lp in enumerate(tree[part]):
            for j, bp in enumerate(lp["blocks"]):
                block(f"unet.{part}.layers.{i}.conv.{j}", bp)
    for i, lp in enumerate(tree["decoder"]):
        w = np.flip(lp["convt"]["w"], axis=(0, 1))
        sd[f"unet.decoder.layers.{i}.conv1.0.weight"] = np.transpose(w, (2, 3, 0, 1))
        bn(f"unet.decoder.layers.{i}.conv1.1", w.shape[-1])
        for j, bp in enumerate(lp["blocks"]):
            block(f"unet.decoder.layers.{i}.conv2.{j}", bp)
    conv("cnn", tree["cnn"])
    names = {"w_ih": "weight_ih_l0", "w_hh": "weight_hh_l0", "b_ih": "bias_ih_l0",
             "b_hh": "bias_hh_l0"}
    for k, v in names.items():
        sd[f"fc.0.gru.{v}"] = tree["gru"][k]
        sd[f"fc.0.gru.{v}_reverse"] = tree["gru"][k + "_r"]
    sd["fc.1.weight"] = tree["fc"]["w"].T
    sd["fc.1.bias"] = tree["fc"]["b"]
    return {k: torch.as_tensor(np.ascontiguousarray(v, np.float32)) for k, v in sd.items()}


def hubert_state_dict(tree):
    """A JAX-layout HuBERT tree (layer leaves stacked) as a fairseq
    checkpoint's "model" state dict (`models.hubert.load_hubert_pt` reads
    it back), the positional conv split into weight_g/weight_v."""
    sd = {}

    def lin(prefix, p, i=None):
        w, b = np.asarray(p["w"]), np.asarray(p["b"])
        if i is not None:
            w, b = w[i], b[i]
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = w.T, b

    def ln(prefix, p, i=None):
        g, b = np.asarray(p["gamma"]), np.asarray(p["beta"])
        if i is not None:
            g, b = g[i], b[i]
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = g, b

    for i, c in enumerate(tree["frontend"]["convs"]):
        sd[f"feature_extractor.conv_layers.{i}.0.weight"] = np.transpose(c["w"], (2, 1, 0))
    ln("feature_extractor.conv_layers.0.2", tree["frontend"]["gn"])
    ln("layer_norm", tree["ln_feats"])
    lin("post_extract_proj", tree["post_proj"])
    w = np.transpose(np.asarray(tree["pos_conv"]["w"]), (2, 1, 0))
    sd["encoder.pos_conv.0.weight_g"] = np.sqrt(np.square(w).sum(axis=(0, 1), keepdims=True))
    sd["encoder.pos_conv.0.weight_v"] = w
    sd["encoder.pos_conv.0.bias"] = tree["pos_conv"]["b"]
    ln("encoder.layer_norm", tree["ln_pre"])
    st = tree["layers"]
    for i in range(np.asarray(st["fc1"]["w"]).shape[0]):
        p = f"encoder.layers.{i}"
        for k, m in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
            lin(f"{p}.self_attn.{m}", st["attn"][k], i)
        ln(f"{p}.self_attn_layer_norm", st["ln1"], i)
        lin(f"{p}.fc1", st["fc1"], i)
        lin(f"{p}.fc2", st["fc2"], i)
        ln(f"{p}.final_layer_norm", st["ln2"], i)
    lin("final_proj", tree["final_proj"])
    return {k: torch.as_tensor(np.ascontiguousarray(v, np.float32)) for k, v in sd.items()}


# ---------------------------------------------------------------------------
# Demucs (HTDemucs / HDemucs): the JAX tree, and a reference state dict
# ---------------------------------------------------------------------------

def _dm_conv(p) -> dict:
    """conv1d (K, Cin, Cout) -> (Cout, Cin, K); conv2d HWIO -> OIHW."""
    w = np.asarray(p["w"])
    w = np.transpose(w, (3, 2, 0, 1)) if w.ndim == 4 else np.transpose(w, (2, 1, 0))
    out = {"w": _t(np.ascontiguousarray(w))}
    if p.get("b") is not None:
        out["b"] = _t(p["b"])
    return out


def _dm_convt(p) -> dict:
    """convT1d (K, Cin, Cout) -> (Cin, Cout, K); convT2d, stored
    pre-flipped HWIO in JAX, -> un-flipped (Cin, Cout, Kh, Kw)."""
    w = np.asarray(p["w"])
    if w.ndim == 4:
        w = np.transpose(np.flip(w, axis=(0, 1)), (2, 3, 0, 1))
    else:
        w = np.transpose(w, (1, 2, 0))
    out = {"w": _t(np.ascontiguousarray(w))}
    if p.get("b") is not None:
        out["b"] = _t(p["b"])
    return out


def _dm_norm(p):
    if p is None:
        return None
    return {"gamma": _t(p["gamma"]), "beta": _t(p["beta"]), "groups": int(p.get("groups", 1))}


def _dm_dconv(p) -> dict:
    from ..models.demucs import make_blstm

    layers = []
    for lp in p["layers"]:
        layer = {"conv1": _dm_conv(lp["conv1"]), "norm1": _dm_norm(lp.get("norm1")),
                 "kernel": int(lp["kernel"]), "dilation": int(lp["dilation"]),
                 "conv2": _dm_conv(lp["conv2"]), "norm2": _dm_norm(lp.get("norm2")),
                 "scale": _t(lp["scale"])}
        if "lstm" in lp:
            names = {"w_ih": "weight_ih_l{}", "w_hh": "weight_hh_l{}", "b_ih": "bias_ih_l{}",
                     "b_hh": "bias_hh_l{}"}
            weights = {}
            for i, ll in enumerate(lp["lstm"]["layers"]):
                for key, name in names.items():
                    weights[name.format(i)] = ll[key]
                    weights[name.format(i) + "_reverse"] = ll[key + "_r"]
            layer["lstm"] = {"lstm": make_blstm(weights), "linear": _lin(lp["lstm"]["linear"])}
        if "attn" in lp:
            # LocalState's 1x1 convs: JAX linear (Cin, Cout) -> (Cout, Cin, 1)
            layer["attn"] = {k: {"w": _t(np.asarray(v["w"]).T[:, :, None]), "b": _t(v["b"])}
                             for k, v in lp["attn"].items()}
        layers.append(layer)
    return {"layers": layers}


def _dm_layer(p) -> dict:
    out = {k: (bool(p[k]) if k in ("freq", "empty", "last") else int(p[k]))
           for k in ("freq", "stride", "pad", "last", "chin", "empty") if k in p}
    if "conv" in p:
        out["conv"] = _dm_conv(p["conv"])
    if "conv_tr" in p:
        out["conv_tr"] = _dm_convt(p["conv_tr"])
    for name in ("norm1", "norm2"):
        if name in p:
            out[name] = _dm_norm(p[name])
    if "rewrite" in p:
        out["rewrite"] = _dm_conv(p["rewrite"])
    if "dconv" in p:
        out["dconv"] = _dm_dconv(p["dconv"])
    return out


def _dm_t_layer(p) -> dict:
    out = {"attn": {"in_w": _t(p["attn"]["in_w"]), "in_b": _t(p["attn"]["in_b"]),
                    "out": _lin(p["attn"]["out"])},
           "fc1": _lin(p["fc1"]), "fc2": _lin(p["fc2"]),
           "gamma1": _t(p["gamma1"]), "gamma2": _t(p["gamma2"])}
    for name in ("norm1", "norm2", "norm2k"):
        if name in p:
            out[name] = _ln(p[name])
    if "norm_out" in p:
        out["norm_out"] = _dm_norm(p["norm_out"])
    return out


def demucs_from_jax(tree, cfg) -> dict:
    """The JAX package's Demucs tree (`htdemucs_params_from_state_dict`:
    numpy arrays in its layouts, Python structure flags) -> the port's
    (`models/demucs.py` `params_from_state_dict`'s), on the CPU."""
    if len(tree["encoder"]) != cfg.depth:
        raise ValueError(f"the tree has {len(tree['encoder'])} encoders, the config "
                         f"depth {cfg.depth}")
    out = {k: [_dm_layer(p) for p in tree[k]]
           for k in ("encoder", "decoder", "tencoder", "tdecoder")}
    if "freq_emb" in tree:
        out["freq_emb"] = _t(tree["freq_emb"])
    if "transformer" in tree:
        tp = tree["transformer"]
        out["transformer"] = {"norm_in": _ln(tp["norm_in"]), "norm_in_t": _ln(tp["norm_in_t"]),
                              "layers": [{"z": _dm_t_layer(lp["z"]), "t": _dm_t_layer(lp["t"])}
                                         for lp in tp["layers"]]}
    return out


def random_demucs_state_dict(cfg, channels: int = 48, *, t_layers: int = 5,
                             seed: int = 0) -> dict:
    """A state dict with the reference modules' names and shapes (the
    demucs v4 `HTDemucs` constructor when cfg.has_transformer, else
    `HDemucs`; growth 2, dconv_mode 1, DConv depth 2, rewrite with context
    1 (decoders) and 0 (encoders), GroupNorm(4) from layer 4, transformer
    feed-forward 4x), drawn from `seed`: convolutions normal(0, 1.4 /
    sqrt(fan_in)), which keeps the stems near the mix's scale, norms near
    1, LayerScales 0.05-0.15 (the reference starts them at 1e-3 / 1e-4;
    larger ones make the DConv branches and the transformer count in a
    comparison).  HTDemucs compresses its DConv 8x with no BLSTM or
    LocalState; HDemucs 4x, with both from layer 4."""
    rs = np.random.RandomState(seed)
    ht = cfg.has_transformer
    growth, gain, norm_starts, norm_groups, context, context_enc = 2, 1.4, 4, 4, 1, 0
    dconv_comp, dconv_depth = (8 if ht else 4), 2
    dconv_lstm = dconv_attn = cfg.depth + 1 if ht else 4          # the first layer with them
    heads, ndecay = 4, 4
    sd: dict = {}

    def conv(name, cout, cin, *kernel):
        sd[f"{name}.weight"] = rs.randn(cout, cin, *kernel) * (
            gain / math.sqrt(cin * int(np.prod(kernel))))
        sd[f"{name}.bias"] = rs.randn(cout) * 0.05

    def norm(name, c):
        sd[f"{name}.weight"] = 1.0 + 0.1 * rs.randn(c)
        sd[f"{name}.bias"] = 0.1 * rs.randn(c)

    def lin(name, cout, cin):
        conv(name, cout, cin)

    def dconv(prefix, ch, index):
        hidden = int(ch / dconv_comp)
        for d in range(dconv_depth):
            lp = f"{prefix}.layers.{d}"
            conv(f"{lp}.0", hidden, ch, 3)
            norm(f"{lp}.1", hidden)
            idx = 3
            if index >= dconv_lstm:
                bound = 1.0 / math.sqrt(hidden)
                for layer in range(2):
                    n_in = hidden if layer == 0 else 2 * hidden
                    for sfx in ("", "_reverse"):
                        for name, shape in (("weight_ih", (4 * hidden, n_in)),
                                            ("weight_hh", (4 * hidden, hidden)),
                                            ("bias_ih", (4 * hidden,)), ("bias_hh", (4 * hidden,))):
                            sd[f"{lp}.{idx}.lstm.{name}_l{layer}{sfx}"] = rs.uniform(
                                -bound, bound, shape)
                lin(f"{lp}.{idx}.linear", hidden, 2 * hidden)
                idx += 1
            if index >= dconv_attn:
                for name, cout in (("content", hidden), ("query", hidden), ("key", hidden),
                                   ("query_decay", heads * ndecay), ("proj", hidden)):
                    conv(f"{lp}.{idx}.{name}", cout, hidden, 1)
                idx += 1
            conv(f"{lp}.{idx}", 2 * ch, hidden, 1)
            norm(f"{lp}.{idx + 1}", 2 * ch)
            sd[f"{lp}.{idx + 3}.scale"] = rs.uniform(0.05, 0.15, ch)

    def encoder(prefix, cin, cout, ker, freq, use_norm, index, empty=False):
        conv(f"{prefix}.conv", cout, cin, *((ker, 1) if freq else (ker,)))
        if empty:
            return
        if use_norm:
            norm(f"{prefix}.norm1", cout)
        k = 1 + 2 * context_enc
        conv(f"{prefix}.rewrite", 2 * cout, cout, *((k, k) if freq else (k,)))
        if use_norm:
            norm(f"{prefix}.norm2", 2 * cout)
        dconv(f"{prefix}.dconv", cout, index)

    def decoder(prefix, cin, cout, ker, stri, freq, use_norm, empty=False):
        # ConvTranspose (Cin, Cout, K): each output sums cin * ker / stride terms
        sd[f"{prefix}.conv_tr.weight"] = rs.randn(cin, cout, *((ker, 1) if freq else (ker,))) * (
            gain / math.sqrt(max(cin * ker // stri, 1)))
        sd[f"{prefix}.conv_tr.bias"] = rs.randn(cout) * 0.05
        if use_norm:
            norm(f"{prefix}.norm2", cout)
        if empty:
            return
        k = 1 + 2 * context
        conv(f"{prefix}.rewrite", 2 * cin, cin, *((k, k) if freq else (k,)))
        if use_norm:
            norm(f"{prefix}.norm1", 2 * cin)

    chin = cfg.audio_channels
    chin_z = chin * 2 if cfg.cac else chin
    chout = chout_z = channels
    freqs = cfg.nfft // 2
    decs, tdecs = [], []
    for index in range(cfg.depth):
        use_norm = index >= norm_starts
        freq = freqs > 1
        stri, ker = cfg.stride, cfg.kernel_size
        if not freq:
            ker, stri = cfg.time_stride * 2, cfg.time_stride
        last_freq = freq and freqs <= cfg.kernel_size
        if last_freq:
            ker = freqs
            chout_z = chout = max(chout, chout_z)
        encoder(f"encoder.{index}", chin_z, chout_z, ker, freq, use_norm, index)
        if freq:
            encoder(f"tencoder.{index}", chin, chout, cfg.kernel_size, False, use_norm, index,
                    empty=last_freq)
        if index == 0:
            chin = cfg.audio_channels * len(cfg.sources)
            chin_z = chin * 2 if cfg.cac else chin
        decs.append((chout_z, chin_z, ker, stri, freq, use_norm, False))
        if freq:
            tdecs.append((chout, chin, cfg.kernel_size, cfg.stride, False, use_norm, last_freq))
        chin, chin_z = chout, chout_z
        chout, chout_z = int(growth * chout), int(growth * chout_z)
        if freq:
            freqs = 1 if freqs <= cfg.kernel_size else freqs // cfg.stride
        if index == 0 and cfg.freq_emb_scale:
            # ScaledEmbedding(freqs, chin_z), read back x emb_scale (10)
            sd["freq_emb.embedding.weight"] = rs.randn(freqs, chin_z) * 0.05
    # the decoder lists run deepest first (reference insert(0, ...))
    for i, args in enumerate(reversed(decs)):
        decoder(f"decoder.{i}", *args)
    for i, args in enumerate(reversed(tdecs)):
        decoder(f"tdecoder.{i}", *args)
    if ht and t_layers:
        dim = channels * growth ** (cfg.depth - 1)
        hidden = 4 * dim
        norm("crosstransformer.norm_in", dim)
        norm("crosstransformer.norm_in_t", dim)
        for i in range(t_layers):
            cross = i % 2 == 1
            for branch in ("layers", "layers_t"):
                p = f"crosstransformer.{branch}.{i}"
                attn = "cross_attn" if cross else "self_attn"
                sd[f"{p}.{attn}.in_proj_weight"] = rs.randn(3 * dim, dim) / math.sqrt(dim)
                sd[f"{p}.{attn}.in_proj_bias"] = rs.randn(3 * dim) * 0.05
                lin(f"{p}.{attn}.out_proj", dim, dim)
                lin(f"{p}.linear1", hidden, dim)
                lin(f"{p}.linear2", dim, hidden)
                for name in ("norm1", "norm2") + (("norm3",) if cross else ()):
                    norm(f"{p}.{name}", dim)
                norm(f"{p}.norm_out", dim)
                sd[f"{p}.gamma_1.scale"] = rs.uniform(0.05, 0.15, dim)
                sd[f"{p}.gamma_2.scale"] = rs.uniform(0.05, 0.15, dim)
    return {k: torch.as_tensor(np.ascontiguousarray(v, np.float32)) for k, v in sd.items()}


# ---------------------------------------------------------------------------
# Whisper and ECAPA-TDNN (models/whisper.py, models/ecapa_tdnn.py)
# ---------------------------------------------------------------------------

TRANSCRIPT_FREQS = 6              # planes of the timestamp code
TRANSCRIPT_TS_PER_POSITION = 25   # 0.5 s of timestamp per decoder position
TRANSCRIPT_EOT_POSITION = 41      # the last timestamp near 20 s, then the end of text


def random_whisper_tree(dims, seed: int = 0, *, transcript: bool = False) -> dict:
    """Whisper params drawn from `seed` in the JAX layouts (linear (Cin,
    Cout), conv (K, Cin, Cout)), as JAX `params_from_state_dict` lays them
    out: linears and convs uniform(+-1 / sqrt(fan_in)) as torch's default
    init, layer norms near 1, the token embedding normal(0, 1) as
    nn.Embedding's, the decoder positions normal(0, 0.02).

    transcript=True shapes the draws so that greedy decoding of the
    multilingual layout writes timestamped text, as a trained model does,
    instead of repeating one token: the timestamp tokens' embeddings turn
    at six rates in six planes (a code whose dot products peak where two
    timestamps meet) and share a direction w; the decoder positions are
    made to dominate the residual stream, each even position p pointing
    at timestamp 25 p's code (0.5 s more per position), each odd one away
    from w and at a random direction (a varied text token), and from
    position 41 on at the end-of-text token's embedding, which is set
    apart from all of these directions.  A window so decodes
    <|t|> text pairs up to about 20 s, then ends."""
    from ..models.whisper import sinusoids

    rs = np.random.RandomState(seed)

    def f32(a):
        return np.asarray(a, np.float32)

    def lin(cin, cout, bias=True):
        bound = 1.0 / math.sqrt(cin)
        out = {"w": f32(rs.uniform(-bound, bound, (cin, cout)))}
        if bias:
            out["b"] = f32(rs.uniform(-bound, bound, cout))
        return out

    def ln(c):
        return {"gamma": f32(1.0 + 0.1 * rs.randn(c)), "beta": f32(0.1 * rs.randn(c))}

    def conv(k, cin, cout):
        bound = 1.0 / math.sqrt(k * cin)
        return {"w": f32(rs.uniform(-bound, bound, (k, cin, cout))),
                "b": f32(rs.uniform(-bound, bound, cout))}

    def attn(c):
        return {"q": lin(c, c), "k": lin(c, c, bias=False), "v": lin(c, c), "o": lin(c, c)}

    def block(c, cross):
        b = {"attn": attn(c), "attn_ln": ln(c), "fc1": lin(c, 4 * c), "fc2": lin(4 * c, c),
             "mlp_ln": ln(c)}
        if cross:
            b["cross_attn"], b["cross_ln"] = attn(c), ln(c)
        return b

    ca, ct = dims.n_audio_state, dims.n_text_state
    enc = {"conv1": conv(3, dims.n_mels, ca), "conv2": conv(3, ca, ca),
           "pos": sinusoids(dims.n_audio_ctx, ca),
           "blocks": [block(ca, False) for _ in range(dims.n_audio_layer)],
           "ln_post": ln(ca)}
    dec = {"tok_emb": f32(rs.randn(dims.n_vocab, ct)),
           "pos_emb": f32(0.02 * rs.randn(dims.n_text_ctx, ct)),
           "blocks": [block(ct, True) for _ in range(dims.n_text_layer)], "ln": ln(ct)}
    if transcript:
        emb, pos = dec["tok_emb"], dec["pos_emb"]
        basis = np.linalg.qr(rs.randn(ct, 2 * TRANSCRIPT_FREQS + 2))[0].T * math.sqrt(ct)
        w, end, planes = basis[-2], basis[-1], basis[:-2].reshape(TRANSCRIPT_FREQS, 2, ct)
        theta = math.pi / 1700 * 2.0 ** np.arange(TRANSCRIPT_FREQS)

        def turn(angles):                  # (n,) -> (n, ct): a point on every plane
            a = angles[:, None, None] * theta[None, :, None]
            return (np.cos(a) * planes[None, :, 0] + np.sin(a) * planes[None, :, 1]).sum(1) \
                / math.sqrt(TRANSCRIPT_FREQS)

        ts0, eot = dims.n_vocab - 1501, dims.n_vocab - 1608
        emb[ts0:] += 3.0 * turn(np.arange(1501.0)) + 3.0 * w
        p = np.arange(dims.n_text_ctx)
        odd = rs.randn(dims.n_text_ctx, ct)
        odd -= np.outer(odd @ end, end) / ct
        odd *= math.sqrt(ct) / np.linalg.norm(odd, axis=1, keepdims=True)
        pos += np.where((p % 2 == 0)[:, None], 20.0 * turn(TRANSCRIPT_TS_PER_POSITION * p),
                        20.0 * 0.7 * (odd - w)).astype(np.float32)
        emb[eot] = 1.5 * end
        pos[TRANSCRIPT_EOT_POSITION:] = 60.0 * end
    return {"encoder": enc, "decoder": dec}


def whisper_state_dict(tree) -> dict:
    """A JAX-layout Whisper tree -> the reference Whisper's state dict
    (`model_state_dict` of a `.pt`), fp32 tensors."""
    sd: dict = {}

    def lin(name, p):
        sd[f"{name}.weight"] = _t(np.asarray(p["w"]).T)
        if p.get("b") is not None:
            sd[f"{name}.bias"] = _t(p["b"])

    def ln(name, p):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = _t(p["gamma"]), _t(p["beta"])

    def blocks(prefix, bl):
        for i, b in enumerate(bl):
            bp = f"{prefix}.blocks.{i}"
            for key, name in (("attn", "attn"), ("cross_attn", "cross_attn")):
                if key in b:
                    for k, m in (("q", "query"), ("k", "key"), ("v", "value"), ("o", "out")):
                        lin(f"{bp}.{name}.{m}", b[key][k])
            ln(f"{bp}.attn_ln", b["attn_ln"])
            if "cross_ln" in b:
                ln(f"{bp}.cross_attn_ln", b["cross_ln"])
            lin(f"{bp}.mlp.0", b["fc1"])
            lin(f"{bp}.mlp.2", b["fc2"])
            ln(f"{bp}.mlp_ln", b["mlp_ln"])

    enc, dec = tree["encoder"], tree["decoder"]
    for name in ("conv1", "conv2"):
        sd[f"encoder.{name}.weight"] = _conv(enc[name])["w"]
        sd[f"encoder.{name}.bias"] = _t(enc[name]["b"])
    sd["encoder.positional_embedding"] = _t(enc["pos"])
    blocks("encoder", enc["blocks"])
    ln("encoder.ln_post", enc["ln_post"])
    sd["decoder.token_embedding.weight"] = _t(dec["tok_emb"])
    sd["decoder.positional_embedding"] = _t(dec["pos_emb"])
    blocks("decoder", dec["blocks"])
    ln("decoder.ln", dec["ln"])
    return sd


def whisper_from_jax(tree, dims):
    """A JAX-layout Whisper tree -> the port's `models.whisper.Whisper` on
    the CPU."""
    from ..models.whisper import params_from_state_dict

    return params_from_state_dict(whisper_state_dict(tree), dims)


def write_whisper_pt(path: str, tree, dims) -> str:
    """A reference-layout Whisper checkpoint, {"dims", "model_state_dict"},
    of a JAX-layout tree."""
    import dataclasses

    torch.save({"dims": dataclasses.asdict(dims), "model_state_dict": whisper_state_dict(tree)},
               path)
    return path


def random_ecapa_tree(seed: int = 0) -> dict:
    """ECAPA-TDNN params at its only width (models/ecapa_tdnn.py) drawn
    from `seed` in the JAX layout: convs (K, Cin, Cout) normal(0,
    1 / sqrt(fan_in)), biases 0.05 x normal, each BatchNorm folded into a
    scale near 1 and a small shift."""
    from ..models import ecapa_tdnn as ec

    rs = np.random.RandomState(seed)

    def conv(k, cin, cout, bias=True):
        out = {"w": (rs.randn(k, cin, cout) / math.sqrt(k * cin)).astype(np.float32)}
        if bias:
            out["b"] = (0.05 * rs.randn(cout)).astype(np.float32)
        return out

    def bn(c):
        return {"scale": (1.0 + 0.1 * rs.randn(c)).astype(np.float32),
                "shift": (0.1 * rs.randn(c)).astype(np.float32)}

    def tdnn(k, cin, cout):
        return {"conv": conv(k, cin, cout), "bn": bn(cout)}

    ch, ks = ec.CHANNELS, ec.KERNELS
    sub = ch[1] // ec.RES2NET_SCALE
    blocks = [tdnn(ks[0], 80, ch[0])]                 # 80 mel bands in
    for i in range(1, len(ch) - 1):
        blocks.append({"tdnn1": tdnn(1, ch[i - 1], ch[i]),
                       "res2net": {"blocks": [tdnn(ks[i], sub, sub)
                                              for _ in range(ec.RES2NET_SCALE - 1)]},
                       "tdnn2": tdnn(1, ch[i], ch[i]),
                       "se": {"conv1": conv(1, ch[i], 128), "conv2": conv(1, 128, ch[i])}})
    mfa = ch[-1]
    return {"blocks": blocks, "mfa": tdnn(1, 3 * ch[1], mfa),
            "asp": {"tdnn": tdnn(1, 3 * mfa, 128), "conv": conv(1, 128, mfa)},
            "asp_bn": bn(2 * mfa), "fc": conv(1, 2 * mfa, 192)}


def ecapa_from_jax(tree) -> dict:
    """A JAX-layout ECAPA tree -> the port's tree (conv weights (Cout,
    Cin, K))."""
    if isinstance(tree, dict):
        if "w" in tree and np.ndim(tree["w"]) == 3:
            return _conv(tree)
        return {k: ecapa_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [ecapa_from_jax(v) for v in tree]
    return _t(tree)


def ecapa_state_dict(tree, rs, eps: float = 1e-5) -> dict:
    """The reference ECAPA_TDNN's state dict of a JAX-layout tree: each
    folded BatchNorm unfolded over random running statistics from `rs`
    (var in [0.5, 2], mean 0.1 x normal), so that folding it again gives
    the tree's scale and shift back."""
    sd: dict = {}

    def conv(prefix, p):
        sd[f"{prefix}.conv.weight"] = _conv(p)["w"]
        if p.get("b") is not None:
            sd[f"{prefix}.conv.bias"] = _t(p["b"])

    def bn(prefix, p):
        scale, shift = np.asarray(p["scale"], np.float64), np.asarray(p["shift"], np.float64)
        var = rs.uniform(0.5, 2.0, scale.shape)
        mean = 0.1 * rs.randn(*scale.shape)
        sd[f"{prefix}.norm.weight"] = _t(scale * np.sqrt(var + eps))
        sd[f"{prefix}.norm.bias"] = _t(shift + mean * scale)
        sd[f"{prefix}.norm.running_mean"] = _t(mean)
        sd[f"{prefix}.norm.running_var"] = _t(var)
        sd[f"{prefix}.norm.num_batches_tracked"] = torch.tensor(0)

    def tdnn(prefix, p):
        conv(f"{prefix}.conv", p["conv"])
        bn(f"{prefix}.norm", p["bn"])

    tdnn("blocks.0", tree["blocks"][0])
    for i, b in enumerate(tree["blocks"][1:], start=1):
        bp = f"blocks.{i}"
        tdnn(f"{bp}.tdnn1", b["tdnn1"])
        for j, r in enumerate(b["res2net"]["blocks"]):
            tdnn(f"{bp}.res2net_block.blocks.{j}", r)
        tdnn(f"{bp}.tdnn2", b["tdnn2"])
        conv(f"{bp}.se_block.conv1", b["se"]["conv1"])
        conv(f"{bp}.se_block.conv2", b["se"]["conv2"])
        if "shortcut" in b:
            conv(f"{bp}.shortcut", b["shortcut"])
    tdnn("mfa", tree["mfa"])
    tdnn("asp.tdnn", tree["asp"]["tdnn"])
    conv("asp.conv", tree["asp"]["conv"])
    bn("asp_bn", tree["asp_bn"])
    conv("fc", tree["fc"])
    return sd


def write_tiktoken_vocab(path: str) -> str:
    """A `.tiktoken` vocabulary ("base64(bytes) rank" lines) of the
    released file's format and size (50,257 ranks: with Whisper's 1,608
    specials, 51,865 tokens): the 256 single bytes, then deterministic
    merges, each an earlier token of at most 8 bytes followed by one of
    lower-case letters, space and ".,'" (one merge in ten by any single
    byte), so that text decodes to words."""
    import base64

    rs = np.random.RandomState(0)
    tokens = [bytes([i]) for i in range(256)]
    seen = set(tokens)
    text = [bytes([b]) for b in b"abcdefghijklmnopqrstuvwxyz .,'"]
    heads = list(text)
    while len(tokens) < 50257:
        tail = text if rs.rand() < 0.9 else tokens[:256]
        tok = heads[rs.randint(len(heads))] + tail[rs.randint(len(tail))]
        if tok in seen:
            continue
        seen.add(tok)
        tokens.append(tok)
        if len(tok) < 8:
            heads.append(tok)
    with open(path, "wb") as f:
        for rank, tok in enumerate(tokens):
            f.write(base64.b64encode(tok) + b" " + str(rank).encode() + b"\n")
    return path
