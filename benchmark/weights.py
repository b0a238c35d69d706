"""Seeded random weights, made on the device, in the port's layouts.

Each maker returns a *spec*: a nested dict / list tree whose leaves are
`Leaf(shape, init, scale)`.  `materialize(spec, seed, device)` draws every
leaf from one `torch.Generator` on the device in a few large calls (one
uniform and one normal draw for the whole tree), so a full-width model
costs milliseconds, not the seconds a host draw takes.  The inits follow
the JAX package's `init_params` (torch's default bounds 1/sqrt(fan_in),
normal(0, 0.01) for the decoder's transposed and resblock convs), with
one change listed under `assumed` in the configurations: the decoder's
transposed convs and conv_post are drawn 5x wider, so that random weights
give a waveform spanning a good part of [-1, 1].

The same tensors go to the program and to the plain reference; the
reference reads nothing the program made.  RMVPE's BiGRU is given as its
eight raw tensors (`gru_raw`): the program's tree holds an `nn.GRU` built
from them (`program_rmvpe`), the reference builds its own.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

DECODER_SCALE = 5.0     # the decoder's ups and conv_post, x the JAX init


@dataclasses.dataclass(frozen=True)
class Leaf:
    shape: tuple
    init: str            # "uniform" (+-scale), "normal" (std scale), "ones", "zeros"
    scale: float = 0.0


def _u(shape, fan_in):
    return Leaf(tuple(shape), "uniform", 1.0 / math.sqrt(fan_in))


def _n(shape, std):
    return Leaf(tuple(shape), "normal", float(std))


def _ones(shape):
    return Leaf(tuple(shape), "ones")


def _zeros(shape):
    return Leaf(tuple(shape), "zeros")


def _lin(cin, cout, zero_bias=False):
    return {"w": _u((cout, cin), cin), "b": _zeros((cout,)) if zero_bias else _u((cout,), cin)}


def _conv(k, cin, cout):
    return {"w": _u((cout, cin, k), cin * k), "b": _u((cout,), cin * k)}


def _ln(c):
    return {"gamma": _ones((c,)), "beta": _zeros((c,))}


# ---------------------------------------------------------------------------
# synthesizer (the port's `interop/from_jax.py` synthesizer_from_jax layout)
# ---------------------------------------------------------------------------

def _stage_geometry(cfg: dict):
    rates = cfg["upsample_rates"]
    n = len(rates)
    out = []
    for i, (u, k) in enumerate(zip(rates, cfg["upsample_kernel_sizes"])):
        stride = math.prod(rates[i + 1:]) if i + 1 < n else 1
        out.append((u, k, 1 if stride == 1 else stride * 2 - stride % 2))
    return out


def synthesizer_spec(cfg: dict, *, train: bool = False) -> dict:
    """The NSF synthesizer of `cfg` (a configuration file's "model"
    group); train=True adds the posterior encoder `enc_q`."""
    h, inter = cfg["hidden_channels"], cfg["inter_channels"]
    k_ch = h // cfg["n_heads"]
    w = 2 * cfg["rel_attn_window_size"] + 1
    ks, fc = cfg["kernel_size"], cfg["filter_channels"]
    layers = [{
        "attn": {"q": _lin(h, h), "k": _lin(h, h), "v": _lin(h, h), "o": _lin(h, h),
                 "emb_rel_k": _n((1, w, k_ch), k_ch ** -0.5),
                 "emb_rel_v": _n((1, w, k_ch), k_ch ** -0.5)},
        "norm1": _ln(h),
        "ffn": {"conv1": _conv(ks, h, fc), "conv2": _conv(ks, fc, h)},
        "norm2": _ln(h),
    } for _ in range(cfg["n_layers"])]
    enc_p = {"emb_phone": _lin(cfg["text_enc_hidden_dim"], h),
             "encoder": {"layers": layers}, "proj": _lin(h, 2 * inter),
             "emb_pitch": {"w": _n((256, h), 1.0)}}

    def wavenet(n_layers):
        return {"in_layers": [_conv(5, h, 2 * h) for _ in range(n_layers)],
                "res_skip": [_lin(h, h if i == n_layers - 1 else 2 * h)
                             for i in range(n_layers)],
                "cond": _lin(cfg["gin_channels"], 2 * h * n_layers)}

    flow = {"layers": [{"pre": _lin(inter // 2, h), "enc": wavenet(3),
                        "post": {"w": _n((inter // 2, h), 0.01),
                                 "b": _zeros((inter // 2,))}}
                       for _ in range(4)]}
    uic = cfg["upsample_initial_channel"]
    ups, noise_convs, resblocks = [], [], []
    for i, (_, k, nk) in enumerate(_stage_geometry(cfg)):
        cin, cout = uic // 2 ** i, uic // 2 ** (i + 1)
        ups.append({"w": _n((cin, cout, k), 0.01 * DECODER_SCALE), "b": _zeros((cout,))})
        noise_convs.append(_conv(nk, 1, cout))
        for rk, ds in zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]):
            d = len(ds)
            resblocks.append({"w1": _n((d, rk, cout, cout), 0.01), "b1": _zeros((d, cout)),
                              "w2": _n((d, rk, cout, cout), 0.01), "b2": _zeros((d, cout))})
    c_last = uic // 2 ** len(ups)
    dec = {"conv_pre": _conv(7, inter, uic), "ups": ups, "noise_convs": noise_convs,
           "source": {"l_linear": _lin(1, 1)}, "resblocks": resblocks,
           "conv_post": {"w": _n((1, c_last, 7), 0.01 * DECODER_SCALE)},
           "cond": _lin(cfg["gin_channels"], uic)}
    out = {"enc_p": enc_p, "flow": flow, "dec": dec,
           "emb_g": {"w": _n((cfg["spk_embed_dim"], cfg["gin_channels"]), 1.0)}}
    if train:
        out["enc_q"] = {"pre": _lin(cfg["spec_channels"], h), "enc": wavenet(16),
                        "proj": _lin(h, 2 * inter)}
    return out


# ---------------------------------------------------------------------------
# HuBERT / ContentVec (the port's hubert_from_jax layout)
# ---------------------------------------------------------------------------

HUBERT_CONVS = ((512, 10), (512, 3), (512, 3), (512, 3), (512, 3), (512, 2), (512, 2))


def hubert_spec(cfg: dict) -> dict:
    e, f, n = cfg["embed_dim"], cfg["ffn_dim"], cfg["n_layers"]
    k, g = cfg["pos_conv_kernel"], cfg["pos_conv_groups"]
    convs, cin = [], 1
    for dim, kk in HUBERT_CONVS:
        dim = cfg.get("conv_dim", dim)
        convs.append({"w": _n((dim, cin, kk), 1.0 / math.sqrt(kk * cin))})
        cin = dim
    return {
        "frontend": {"convs": convs, "gn": _ln(cin)},
        "ln_feats": _ln(cin), "post_proj": _lin(cin, e, zero_bias=True),
        "pos_conv": {"w": _n((e, e // g, k), math.sqrt(4.0 / (k * e))), "b": _zeros((e,))},
        "ln_pre": _ln(e),
        "layers": [{"attn": {q: _lin(e, e, zero_bias=True) for q in ("q", "k", "v", "o")},
                    "ln1": _ln(e), "fc1": _lin(e, f, zero_bias=True),
                    "fc2": _lin(f, e, zero_bias=True), "ln2": _ln(e)} for _ in range(n)],
        "final_proj": _lin(e, 256, zero_bias=True),
    }


# ---------------------------------------------------------------------------
# RMVPE (the port's rmvpe_from_jax layout, the BiGRU as raw tensors)
# ---------------------------------------------------------------------------

def rmvpe_spec(cfg: dict) -> dict:
    widths, inter_w = cfg["widths"], cfg["inter_width"]
    hdim, n_class = cfg["gru_hidden"], cfg["n_class"]

    def conv(cin, cout, k=3):
        return {"w": _n((cout, cin, k, k), 1.0 / math.sqrt(k * k * cin))}

    def bn(c):
        return {"scale": _ones((c,)), "shift": _zeros((c,))}

    def block(cin, cout):
        p = {"conv1": conv(cin, cout), "bn1": bn(cout), "conv2": conv(cout, cout),
             "bn2": bn(cout)}
        if cin != cout:
            p["shortcut"] = {"w": conv(cin, cout, 1)["w"], "b": _zeros((cout,))}
        return p

    def level(cin, cout):
        return {"blocks": [block(cin, cout)] + [block(cout, cout) for _ in range(3)]}

    chans = [1, *widths]
    dec_chans = [inter_w, *reversed(widths)]
    feat = 3 * cfg["n_mels"]
    return {
        "in_bn": bn(1),
        "encoder": [level(chans[i], chans[i + 1]) for i in range(len(widths))],
        "intermediate": [level(widths[-1], inter_w)] + [level(inter_w, inter_w)
                                                         for _ in range(3)],
        "decoder": [{"convt": {"w": _n((cin, cout, 3, 3), 1.0 / math.sqrt(9 * cin))},
                     "bn": bn(cout), **level(cout * 2, cout)}
                    for cin, cout in zip(dec_chans[:-1], dec_chans[1:])],
        "cnn": {"w": conv(widths[0], 3)["w"], "b": _zeros((3,))},
        "gru_raw": {"w_ih": _n((3 * hdim, feat), 0.05), "w_hh": _n((3 * hdim, hdim), 0.05),
                    "b_ih": _zeros((3 * hdim,)), "b_hh": _zeros((3 * hdim,)),
                    "w_ih_r": _n((3 * hdim, feat), 0.05),
                    "w_hh_r": _n((3 * hdim, hdim), 0.05),
                    "b_ih_r": _zeros((3 * hdim,)), "b_hh_r": _zeros((3 * hdim,))},
        "fc": {"w": _n((n_class, 2 * hdim), 0.05), "b": _zeros((n_class,))},
    }


def program_rmvpe(tree: dict) -> dict:
    """The program's RMVPE tree: `gru_raw` replaced by the port's `nn.GRU`
    (`models/rmvpe.py` make_bigru, on the tensors' device)."""
    from rvc_maker_tpu_torch.models.rmvpe import make_bigru

    out = {k: v for k, v in tree.items() if k != "gru_raw"}
    out["gru"] = make_bigru(tree["gru_raw"]).to(tree["gru_raw"]["w_ih"].device)
    return out


# ---------------------------------------------------------------------------
# discriminators (the port's discriminator_from_jax layout, weight norm live)
# ---------------------------------------------------------------------------

PERIODS_V2 = (2, 3, 5, 7, 11, 17, 23, 37)
S_CONVS = ((1, 16, 15, 1), (16, 64, 41, 4), (64, 256, 41, 16), (256, 1024, 41, 64),
           (1024, 1024, 41, 256), (1024, 1024, 5, 1))      # (cin, cout, k, groups)
P_CHANNELS = ((1, 32), (32, 128), (128, 512), (512, 1024), (1024, 1024))


def _wn(v_shape):
    """A weight-normed conv: v uniform +-1/sqrt(fan_in), g = ||v|| per
    output channel (filled in by `materialize`), b like v."""
    fan = math.prod(v_shape[1:])
    return {"g": Leaf((v_shape[0],) + (1,) * (len(v_shape) - 1), "norm_of_v"),
            "v": _u(v_shape, fan), "b": _u((v_shape[0],), fan)}


def discriminator_spec(version: str = "v2") -> dict:
    if version != "v2":
        raise ValueError("only the v2 discriminator set is made")
    return {"s": {"convs": [_wn((cout, cin // g, k)) for cin, cout, k, g in S_CONVS],
                  "post": _wn((1, S_CONVS[-1][1], 3))},
            "p": [{"convs": [_wn((cout, cin, 5, 1)) for cin, cout in P_CHANNELS],
                   "post": _wn((1, P_CHANNELS[-1][1], 3, 1))} for _ in PERIODS_V2]}


# ---------------------------------------------------------------------------
# drawing
# ---------------------------------------------------------------------------

def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _rebuild(tree, values: dict, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, values, path + (i,)) for i, v in enumerate(tree)]
    return values[path]


def spec_shapes(spec) -> dict:
    """{"/a/b[0]/w": shape} of every leaf, the paths written as the
    port's trees would print them."""
    def name(path):
        return "".join(f"[{p}]" if isinstance(p, int) else f"/{p}" for p in path)
    return {name(p): leaf.shape for p, leaf in _walk(spec)}


def materialize(spec, seed: int, device, dtype=torch.float32):
    """The spec's tensors on `device`: one uniform and one normal draw
    from a generator on the device seeded `seed`, cut into the leaves in
    tree order, each leaf its own contiguous tensor."""
    leaves = list(_walk(spec))
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    sizes = {kind: sum(math.prod(l.shape) for _, l in leaves if l.init == kind)
             for kind in ("uniform", "normal")}
    flat = {"uniform": torch.rand(sizes["uniform"], generator=gen, device=device,
                                  dtype=dtype).mul_(2.0).sub_(1.0),
            "normal": torch.randn(sizes["normal"], generator=gen, device=device,
                                  dtype=dtype)}
    at = {"uniform": 0, "normal": 0}
    values = {}
    for path, leaf in leaves:
        if leaf.init in flat:
            n = math.prod(leaf.shape)
            t = flat[leaf.init][at[leaf.init]: at[leaf.init] + n].view(leaf.shape)
            values[path] = (t * leaf.scale).contiguous()
            at[leaf.init] += n
        elif leaf.init == "ones":
            values[path] = torch.ones(leaf.shape, device=device, dtype=dtype)
        elif leaf.init == "zeros":
            values[path] = torch.zeros(leaf.shape, device=device, dtype=dtype)
    for path, leaf in leaves:
        if leaf.init == "norm_of_v":
            v = values[path[:-1] + ("v",)]
            values[path] = torch.sqrt(torch.sum(torch.square(v), dim=tuple(range(1, v.dim())),
                                                keepdim=True))
    return _rebuild(spec, values)


def index_rows(n_rows: int, dim: int, seed: int, device) -> torch.Tensor:
    """The retrieval index's rows, standard normal."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    return torch.randn((n_rows, dim), generator=gen, device=device)


def clone_tree(tree: Any) -> Any:
    """A copy of every tensor of a tree (the reference's own copy)."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [clone_tree(v) for v in tree]
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def to_host(tree: Any) -> Any:
    """A host copy of every tensor of a tree."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_host(v) for v in tree]
    return tree.detach().to("cpu", copy=True) if isinstance(tree, torch.Tensor) else tree


def to_device(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree
