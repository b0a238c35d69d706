"""First-run validator for a directory of released model files.

Point it at a directory of downloaded artifacts and it runs every check
that applies, each with the port's own loader: decryption, strict key
maps, a representative forward on --device, the faiss `.index` against
`total_fea.npy`, ONNX graphs run, and the fp32 / bf16 conversion gate.
Each check prints PASS, SKIP (nothing of its class in the directory) or
FAIL, then one summary JSON line follows; the exit code is 1 when any
check failed.

    python -m rvc_maker_tpu_torch.tools.validate_real_weights DIR
        [--lenient] [--audio speech.wav] [--only synth_pth,bf16_gate]
        [--device cuda|cpu]

--lenient leaves out the gates that hold only for trained weights (F0
predictors tracking a 220 Hz tone, the separator's stems summing to the
mix, the reference A/B within 1e-3, bf16 within mel L1 1.0 of fp32); the
structural checks (keys consumed, shapes, decryption, finite outputs,
the index reconstructed byte for byte) always run.  The A/B against the
reference toolkit's own Synthesizer runs when RVC_REFERENCE_ROOT names a
checkout of it, and is skipped otherwise.

The checks, in order: synth_pth, hubert_pt, rmvpe_pt, fcpe_pt, crepe_pth,
whisper_pt, demucs, mdx_onnx, audioldm2_dir, faiss_index, voice_onnx,
f0_onnx, bf16_gate.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import importlib
import json
import os
import sys
import traceback

import numpy as np
import torch

CHECKS = []


def check(name):
    def deco(fn):
        CHECKS.append((name, fn))
        return fn
    return deco


class Ctx:
    def __init__(self, directory: str, *, lenient: bool = False, audio: str = "",
                 device="cuda"):
        from ..device import resolve_device

        self.dir = os.path.abspath(directory)
        self.lenient = lenient
        self.audio_path = audio
        self.device = resolve_device(device)
        self._audio16k = None

    def find(self, *patterns):
        """First file in the directory (recursively) matching a pattern."""
        for pat in patterns:
            hits = sorted(glob.glob(os.path.join(self.dir, "**", pat), recursive=True))
            if hits:
                return hits[0]
        return None

    def find_all(self, *patterns):
        out = []
        for pat in patterns:
            out += sorted(glob.glob(os.path.join(self.dir, "**", pat), recursive=True))
        return out

    def audio16k(self, seconds: float = 1.0) -> np.ndarray:
        """--audio at 16 kHz, else a synthetic 220 Hz voiced tone (enough
        for the structural checks; the quality gates want --audio)."""
        if self._audio16k is None:
            if self.audio_path:
                from ..utils.audio import load_audio

                self._audio16k = np.asarray(load_audio(self.audio_path, 16000), np.float32)
            else:
                t = np.arange(16000 * 4) / 16000.0
                vib = 1 + 0.02 * np.sin(2 * np.pi * 5 * t)
                self._audio16k = (0.4 * np.sin(
                    2 * np.pi * 220 * np.cumsum(vib) / 16000)).astype(np.float32)
        n = int(16000 * seconds)
        a = self._audio16k
        return a[:n] if len(a) >= n else np.pad(a, (0, n - len(a)))

    def tensor(self, a):
        return torch.as_tensor(np.asarray(a), device=self.device)

    def on_device(self, tree):
        from ..device import tree_to

        return tree_to(tree, self.device, torch.float32)


class Skip(Exception):
    pass


def reference_root() -> str | None:
    """The reference toolkit's checkout named by RVC_REFERENCE_ROOT, when
    that is a directory."""
    root = os.environ.get("RVC_REFERENCE_ROOT", "")
    return root if root and os.path.isdir(root) else None


def _shim_module(name: str):
    import importlib.machinery
    import types

    m = types.ModuleType(name)
    m.__spec__ = importlib.machinery.ModuleSpec(name, None)
    return m


def _reference_module(root: str, name: str):
    """A module of the reference toolkit, with stand-ins for the two
    packages it imports at module scope that this project does not need
    (omegaconf, librosa's mel filterbank, from `ops/stft.py`)."""
    if "omegaconf" not in sys.modules:
        om = _shim_module("omegaconf")
        om.DictConfig = type("DictConfig", (dict,), {})
        om.open_dict = contextlib.contextmanager(lambda x: (yield x))
        sys.modules["omegaconf"] = om
    if "librosa" not in sys.modules:
        from ..ops.stft import mel_filterbank

        lib, filters = _shim_module("librosa"), _shim_module("librosa.filters")
        filters.mel = (lambda *, sr, n_fft, n_mels=128, fmin=0.0, fmax=None, htk=False:
                       mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk))
        lib.filters, lib.sequence = filters, _shim_module("librosa.sequence")
        sys.modules.update({"librosa": lib, "librosa.filters": filters,
                            "librosa.sequence": lib.sequence})
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module(name)


@contextlib.contextmanager
def _zero_noise_torch():
    """The reference's implicit draws (randn_like, rand, randn) as zeros."""
    saved = (torch.randn_like, torch.rand, torch.randn)

    def zeros(*s, **kw):
        return torch.zeros(*s, **{k: v for k, v in kw.items() if k in ("device", "dtype")})
    try:
        torch.randn_like = lambda x, **kw: torch.zeros_like(x)
        torch.rand = torch.randn = zeros
        yield
    finally:
        torch.randn_like, torch.rand, torch.randn = saved


def _interchange_pth(ctx: Ctx):
    """First *.pth that is an RVC interchange file (config + weight)."""
    for p in ctx.find_all("*.pth"):
        base = os.path.basename(p)
        if base.startswith(("crepe_", "G_", "D_")) or base == "rmvpe.pth":
            continue
        try:
            c = torch.load(p, map_location="cpu", weights_only=False)
        except Exception:  # noqa: BLE001
            continue
        if isinstance(c, dict) and "config" in c and "weight" in c:
            return p, c
    return None, None


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros(v) for v in tree)
    return torch.zeros_like(tree)


# ---------------------------------------------------------------------------
# 1. RVC interchange .pth
# ---------------------------------------------------------------------------

@check("synth_pth")
def check_synth_pth(ctx: Ctx) -> dict:
    from ..config import model_config_from_ckpt_list
    from ..interop.pth import load_synthesizer_pth
    from ..models import synthesizer as syn

    path, cpt = _interchange_pth(ctx)
    if path is None:
        raise Skip("no interchange .pth (config+weight) found")
    out = {"file": os.path.basename(path)}

    # the 18-element config list -> ModelConfig
    cfg_list = cpt["config"]
    assert len(cfg_list) == 18, f"config list len {len(cfg_list)} != 18"
    use_f0 = bool(cpt.get("f0", 1))
    version = cpt.get("version", "v2")
    # the loader patches spk_embed_dim and the embedding width from the weights
    params, mcfg, _meta = load_synthesizer_pth(path)
    probe = model_config_from_ckpt_list(cfg_list, use_f0=use_f0, version=version,
                                        vocoder=cpt.get("vocoder", "Default"))
    assert probe.sr == mcfg.sr, (probe.sr, mcfg.sr)
    out["version"], out["sr"], out["use_f0"] = version, mcfg.sr, use_f0

    # which weight-norm spelling the file uses
    keys = list(cpt["weight"])
    out["weight_norm_spelling"] = (
        "parametrizations" if any("parametrizations" in k for k in keys)
        else "weight_g/v" if any(k.endswith("weight_g") for k in keys) else "plain")

    b, t = 1, 20
    rs = np.random.RandomState(0)
    phone = rs.randn(b, t, mcfg.text_enc_hidden_dim).astype(np.float32)
    pitch = rs.randint(1, 256, (b, t))
    nsff0 = (rs.rand(b, t) * 300 + 80).astype(np.float32)
    with torch.inference_mode():
        wav = syn.infer_any(
            ctx.on_device(params), mcfg, ctx.tensor(phone), ctx.tensor([t]),
            ctx.tensor(pitch) if use_f0 else None, ctx.tensor(nsff0), ctx.tensor([0]),
            torch.zeros((b, t, mcfg.inter_channels), device=ctx.device),
            _zeros(syn.decoder_noise(mcfg, b, t, None, ctx.device)))
    w = wav.float().cpu().numpy()
    assert np.isfinite(w).all(), "non-finite output"
    out["wav_shape"] = list(w.shape)

    # the A/B against the reference toolkit's own Synthesizer
    root = reference_root()
    if root and use_f0:
        mod = _reference_module(root, "main.library.algorithm.synthesizers")
        net = mod.Synthesizer(*cfg_list, use_f0=use_f0,
                              text_enc_hidden_dim=mcfg.text_enc_hidden_dim,
                              vocoder=cpt.get("vocoder", "Default"))
        if hasattr(net, "enc_q"):
            del net.enc_q
        res = net.load_state_dict(cpt["weight"], strict=False)
        assert not res.unexpected_keys, f"reference rejected keys: {res.unexpected_keys[:5]}"
        net.eval().float()
        with torch.no_grad(), _zero_noise_torch():
            o_ref, _, _ = net.infer(torch.from_numpy(phone), torch.LongTensor([t]),
                                    torch.from_numpy(pitch), torch.from_numpy(nsff0),
                                    torch.LongTensor([0]))
        err = float(np.max(np.abs(o_ref.numpy()[:, 0, :] - w[:, :, 0])))
        out["ref_max_abs_err"] = err
        if not ctx.lenient:
            assert err <= 1e-3, f"reference A/B err {err} > 1e-3"
    return out


# ---------------------------------------------------------------------------
# 2. fairseq HuBERT .pt (and transformers weights files)
# ---------------------------------------------------------------------------

def _load_hubert(path: str):
    from ..models.hubert import load_hubert_pt, load_transformers_dir

    return load_hubert_pt(path) if path.endswith(".pt") else load_transformers_dir(path)


@check("hubert_pt")
def check_hubert(ctx: Ctx) -> dict:
    from ..models import hubert as hubert_mod

    path = ctx.find("*hubert*.pt", "*contentvec*.pt", "*spin*.safetensors")
    if path is None:
        raise Skip("no hubert/contentvec checkpoint found")
    params = ctx.on_device(_load_hubert(path))
    out = {"file": os.path.basename(path)}
    audio = ctx.tensor(ctx.audio16k(1.0)[None])
    lengths = ctx.tensor([audio.shape[1]])
    with torch.inference_mode():
        # v2: the raw layer-12 features
        f = hubert_mod.extract_features(params, audio, lengths, output_layer=12)[0]
        f = f.float().cpu().numpy()
        assert np.isfinite(f).all(), "v2: non-finite features"
        assert f.std() > 1e-5, "v2: degenerate features"
        out["v2_feat_shape"] = list(f.shape)
        # v1: layer 9 and final_proj (contentvec carries the projection head)
        if "final_proj" in params:
            feats9 = hubert_mod.extract_features(params, audio, lengths, output_layer=9)[0]
            p = hubert_mod.final_proj(params, feats9).float().cpu().numpy()
            assert np.isfinite(p).all(), "v1: non-finite projected features"
            out["v1_feat_shape"] = list(p.shape)
    return out


# ---------------------------------------------------------------------------
# 3-4. F0 predictors: rmvpe.pt / fcpe.pt (encrypted or not) / crepe .pth
# ---------------------------------------------------------------------------

def _f0_tone_check(ctx: Ctx, f0, out: dict, label: str):
    f0 = np.asarray(f0).reshape(-1)
    voiced = f0[f0 > 1]
    out[f"{label}_voiced_frac"] = round(float(len(voiced) / max(len(f0), 1)), 3)
    out[f"{label}_median_hz"] = round(float(np.median(voiced)), 1) if len(voiced) else 0.0
    if not ctx.lenient and not ctx.audio_path:
        # the synthetic 220 Hz tone: a trained predictor tracks it
        assert len(voiced) > 0.5 * len(f0), f"{label}: mostly unvoiced"
        med = float(np.median(voiced))
        assert abs(med - 220.0) < 22.0, f"{label}: median {med} != 220 Hz"


@check("rmvpe_pt")
def check_rmvpe(ctx: Ctx) -> dict:
    from ..models import rmvpe as rmvpe_mod

    path = ctx.find("rmvpe.pt")
    if path is None:
        raise Skip("no rmvpe.pt found")
    params = ctx.on_device(rmvpe_mod.load_rmvpe_pt(path))   # shapes of E2E(4, 1, (2, 2))
    with torch.inference_mode():
        f0 = rmvpe_mod.infer(params, ctx.tensor(ctx.audio16k(1.0)[None])).cpu().numpy()
    out = {"file": os.path.basename(path)}
    assert np.isfinite(f0).all()
    _f0_tone_check(ctx, f0, out, "rmvpe")
    return out


@check("fcpe_pt")
def check_fcpe(ctx: Ctx) -> dict:
    from ..interop.modelcrypt import maybe_decrypt
    from ..models import fcpe as fcpe_mod

    paths = [p for p in (ctx.find("fcpe.pt"), ctx.find("fcpe_legacy.pt")) if p]
    if not paths:
        raise Skip("no fcpe checkpoint found")
    out = {}
    for p in paths:
        raw = open(p, "rb").read()
        tag = os.path.basename(p).replace(".pt", "")
        # the released files are AES-encrypted at rest
        out[f"{tag}_was_encrypted"] = maybe_decrypt(raw) != raw
        params, legacy = fcpe_mod.load_fcpe_ckpt(p)
        out[f"{tag}_arch"] = "legacy" if legacy else "current"
        with torch.inference_mode():
            f0 = fcpe_mod.infer(ctx.on_device(params),
                                ctx.tensor(ctx.audio16k(1.0)[None])).cpu().numpy()
        assert np.isfinite(f0).all(), f"{tag}: non-finite f0"
        _f0_tone_check(ctx, f0, out, tag)
    return out


@check("crepe_pth")
def check_crepe(ctx: Ctx) -> dict:
    from ..models import crepe as crepe_mod

    paths = ctx.find_all("crepe_*.pth")
    if not paths:
        raise Skip("no crepe_*.pth found")
    out = {}
    for p in paths:
        cap = os.path.basename(p)[len("crepe_"):-len(".pth")]
        params = ctx.on_device(crepe_mod.load_crepe_pth(p, cap))
        with torch.inference_mode():
            probs = crepe_mod.predict_probs(params, ctx.tensor(ctx.audio16k(0.5)[None]))
        f0 = crepe_mod.decode(probs.float().cpu().numpy())
        assert np.isfinite(f0).all(), f"{cap}: non-finite"
        _f0_tone_check(ctx, f0, out, f"crepe_{cap}")
    return out


# ---------------------------------------------------------------------------
# 5. Whisper .pt
# ---------------------------------------------------------------------------

@check("whisper_pt")
def check_whisper(ctx: Ctx) -> dict:
    from ..models import whisper as whisper_mod

    path = None
    for p in ctx.find_all("*.pt"):
        if "hubert" in p or "contentvec" in p or "fcpe" in p or "rmvpe" in p:
            continue
        try:
            d = torch.load(p, map_location="cpu", weights_only=False)
        except Exception:  # noqa: BLE001
            continue
        if isinstance(d, dict) and "dims" in d:
            path = p
            break
    if path is None:
        raise Skip("no whisper checkpoint (dims dict) found")
    model = whisper_mod.load_whisper_pt(path, device=ctx.device)
    dims = model.dims
    out = {"file": os.path.basename(path),
           "dims": {k: getattr(dims, k) for k in
                    ("n_mels", "n_audio_state", "n_audio_layer", "n_text_layer", "n_vocab")}}
    ck = torch.load(path, map_location="cpu", weights_only=False)
    blob = ck.get("alignment_heads") or ck["dims"].get("alignment_heads")
    if blob is not None:
        heads = whisper_mod.alignment_heads_from_dump(blob, dims)
        out["alignment_heads"] = int(np.asarray(heads).sum())
    with torch.inference_mode():
        mel = whisper_mod.log_mel(ctx.tensor(ctx.audio16k(1.0)[None]), n_mels=dims.n_mels)
        enc = model.encoder(mel).float().cpu().numpy()
    assert np.isfinite(enc).all()
    out["enc_shape"] = list(enc.shape)
    return out


# ---------------------------------------------------------------------------
# 6. Demucs bags
# ---------------------------------------------------------------------------

@check("demucs")
def check_demucs(ctx: Ctx) -> dict:
    from ..interop import demucs_load
    from ..models import demucs as demucs_mod

    bag = ctx.find("*.yaml")
    th = ctx.find("*.th")
    out = {}
    if not bag and not th:
        raise Skip("no demucs .yaml/.th found")
    if bag:
        models = demucs_load.load_demucs_bag(bag, device=ctx.device)
        out["bag"] = os.path.basename(bag)
        out["bag_models"] = len(models)
        params, cfg = models[0][0], models[0][1]
    else:
        params, cfg = demucs_load.load_demucs_th(th, device=ctx.device)
        out["th"] = os.path.basename(th)
    n = int(min(cfg.segment * cfg.samplerate, cfg.samplerate // 2))
    mix = np.stack([ctx.audio16k(0.5)[:n]] * 2)   # stereo
    with torch.inference_mode():
        s = demucs_mod.apply_model_single(params, cfg, ctx.tensor(mix[None])).cpu().numpy()
    assert np.isfinite(s).all(), "non-finite stems"
    out["stems_shape"] = list(s.shape)
    if not ctx.lenient:
        # trained separators about reconstruct the mix
        recon = s[0, :, :, :mix.shape[-1]].sum(axis=0)
        rel = float(np.abs(recon - mix).mean() / (np.abs(mix).mean() + 1e-9))
        out["recon_rel_err"] = round(rel, 3)
        assert rel < 0.5, f"stem sum does not reconstruct mix (rel {rel})"
    return out


# ---------------------------------------------------------------------------
# 7. UVR MDX .onnx
# ---------------------------------------------------------------------------

def _onnx_input_shape(graph, name):
    for vi in graph.graph.input:
        if vi.name == name:
            return [d.dim_value if d.dim_value else 0 for d in vi.type.tensor_type.shape.dim]
    return []


@check("mdx_onnx")
def check_mdx(ctx: Ctx) -> dict:
    from ..interop.onnx_run import OnnxGraph

    path, graph, shape = None, None, None
    for p in ctx.find_all("*.onnx"):
        base = os.path.basename(p).lower()
        if any(k in base for k in ("rmvpe", "crepe", "fcpe")):
            continue
        try:
            g = OnnxGraph(p, device=ctx.device)
        except Exception:  # noqa: BLE001
            continue
        if "model_info" in g.metadata:   # a voice model, not MDX
            continue
        sh = _onnx_input_shape(g, g.input_names[0])
        if len(sh) == 4:   # MDX nets take (B, 4, F, T) spectrograms
            path, graph, shape = p, g, sh
            break
    if path is None:
        raise Skip("no 4-D-input .onnx (MDX) found")
    shape = [d if d > 0 else 8 for d in shape]
    shape[0] = 1
    x = (np.random.RandomState(0).randn(*shape) * 0.1).astype(np.float32)
    with torch.inference_mode():
        y0 = graph.run({graph.input_names[0]: ctx.tensor(x)})[0]
    y0 = np.asarray(y0.float().cpu().numpy() if isinstance(y0, torch.Tensor) else y0)
    assert np.isfinite(y0).all(), "non-finite MDX output"
    return {"file": os.path.basename(path), "in": shape, "out": list(y0.shape)}


# ---------------------------------------------------------------------------
# 8. AudioLDM2 diffusers directory
# ---------------------------------------------------------------------------

@check("audioldm2_dir")
def check_audioldm2(ctx: Ctx) -> dict:
    from ..edit.stack import load_components_from_dir

    root = None
    for d in sorted(glob.glob(os.path.join(ctx.dir, "**/"), recursive=True)):
        if os.path.isdir(os.path.join(d, "unet")) and os.path.isdir(os.path.join(d, "vae")):
            root = d.rstrip("/")
            break
    if root is None:
        raise Skip("no diffusers-layout directory (unet/ + vae/) found")
    comps = load_components_from_dir(root)   # the key maps are strict and raise
    ucfg = comps["unet_cfg"]
    return {"dir": os.path.relpath(root, ctx.dir),
            "components": sorted(k for k in comps if k != "unet_cfg"),
            "unet_blocks": list(ucfg.block_out_channels),
            "unet_cross_dims": [c if c is None else int(c) for c in ucfg.cross_dims]
            if getattr(ucfg, "cross_dims", None) is not None else None}


# ---------------------------------------------------------------------------
# 9. faiss .index against total_fea.npy
# ---------------------------------------------------------------------------

@check("faiss_index")
def check_faiss(ctx: Ctx) -> dict:
    from ..retrieval.faiss_io import read_index

    idx = ctx.find("added_*.index", "*.index")
    if idx is None:
        raise Skip("no faiss .index found")
    index = read_index(idx)
    out = {"file": os.path.basename(idx), "ntotal": int(index.ntotal), "d": int(index.d)}
    fea = ctx.find("total_fea.npy")
    if fea is not None:
        ref = np.load(fea)
        rec = index.reconstruct_n()
        assert rec.shape == ref.shape, (rec.shape, ref.shape)
        assert np.array_equal(rec, ref), \
            "reconstruct_n != total_fea.npy (byte-exact check failed)"
        out["total_fea_byte_exact"] = True
    return out


# ---------------------------------------------------------------------------
# 10. exported voice .onnx
# ---------------------------------------------------------------------------

@check("voice_onnx")
def check_voice_onnx(ctx: Ctx) -> dict:
    from ..interop.onnx_run import OnnxGraph
    from ..interop.onnx_voice import OnnxVoiceModel

    path = None
    for p in ctx.find_all("*.onnx"):
        try:
            g = OnnxGraph(p, device=ctx.device)
        except Exception:  # noqa: BLE001
            continue
        if "model_info" in g.metadata:
            path = p
            break
    if path is None:
        raise Skip("no voice .onnx (model_info metadata) found")
    model = OnnxVoiceModel(path, device=ctx.device)
    cfg = model.cfg
    out = {"file": os.path.basename(path), "sr": cfg.sr, "version": model.version,
           "layout": "torch" if model.torch_layout else "NTC", "dynamic": model.dynamic}
    t = max(20, model.min_frames)
    rs = np.random.RandomState(0)
    with torch.inference_mode():
        wav = model.synth(
            ctx.tensor(rs.randn(1, t, cfg.text_enc_hidden_dim).astype(np.float32)),
            ctx.tensor([t]), ctx.tensor(rs.randint(1, 256, (1, t))),
            ctx.tensor((rs.rand(1, t) * 300 + 80).astype(np.float32)), ctx.tensor([0]),
            torch.zeros((1, t, cfg.inter_channels), device=ctx.device),
            torch.zeros((1, t * cfg.upp, 1), device=ctx.device))
    w = wav.float().cpu().numpy()
    assert np.isfinite(w).all(), "non-finite onnx voice output"
    out["wav_shape"] = list(w.shape)
    return out


# ---------------------------------------------------------------------------
# 11. exported F0 .onnx
# ---------------------------------------------------------------------------

@check("f0_onnx")
def check_f0_onnx(ctx: Ctx) -> dict:
    from ..f0 import onnx_predictor as op
    from ..interop.onnx_run import OnnxGraph

    out = {}
    found = False
    audio = ctx.tensor(ctx.audio16k(0.5)[None])
    for pat, fn in (("rmvpe.onnx", op.rmvpe_onnx_infer), ("crepe_*.onnx", op.crepe_onnx_infer),
                    ("fcpe*.onnx", op.fcpe_onnx_infer)):
        p = ctx.find(pat)
        if p is None:
            continue
        found = True
        graph = OnnxGraph(p, device=ctx.device)   # an unknown op raises NotImplementedError
        with torch.inference_mode():
            f0 = fn(graph, audio)
        f0 = np.asarray(f0.float().cpu().numpy() if isinstance(f0, torch.Tensor) else f0)
        tag = os.path.basename(p).replace(".onnx", "")
        assert np.isfinite(f0).all(), f"{tag}: non-finite"
        out[f"{tag}_frames"] = int(f0.shape[-1])
        _f0_tone_check(ctx, f0, out, tag)
    if not found:
        raise Skip("no f0 .onnx graph found")
    return out


# ---------------------------------------------------------------------------
# 12. the bf16 gate over the whole conversion (needs the .pth and HuBERT)
# ---------------------------------------------------------------------------

@check("bf16_gate")
def check_bf16(ctx: Ctx) -> dict:
    from ..interop.onnx_voice import load_voice_model
    from ..ops.stft import mel_spectrogram
    from ..pipelines.convert import ConvertPipeline, ConvertSettings

    pth, _ = _interchange_pth(ctx)
    hub = ctx.find("*hubert*.pt", "*contentvec*.pt")
    if pth is None or hub is None:
        raise Skip("needs both interchange .pth and hubert .pt")
    synth_params, cfg, meta = load_voice_model(pth, device=ctx.device)
    hubert_params = _load_hubert(hub)
    version = meta.get("version", "v2")
    audio = ctx.audio16k(1.0)[None]
    lens = np.array([audio.shape[1]])
    settings = ConvertSettings(f0_method="yin", deterministic=True)
    outs = {}
    for dtype in (None, torch.bfloat16):
        pipe = ConvertPipeline(synth_params, cfg, hubert_params, version=version,
                               device=ctx.device, compute_dtype=dtype)
        with torch.inference_mode():
            wav, _ = pipe.convert_batch(audio, lens, 0, settings)
        w = wav.float().cpu().numpy()
        del pipe
        name = "bf16" if dtype is not None else "fp32"
        assert np.isfinite(w).all(), f"{name}: non-finite"
        outs[name] = w
    a, b = outs["fp32"], outs["bf16"]
    n = min(a.shape[1], b.shape[1])

    def mel(x):
        return mel_spectrogram(torch.as_tensor(x[:, :n]), n_fft=1024, num_mels=80,
                               sample_rate=cfg.sr, hop_length=256, win_length=1024,
                               fmin=0.0, fmax=None).numpy()
    dist = float(np.mean(np.abs(mel(a) - mel(b))))
    out = {"mel_l1": round(dist, 4)}
    if not ctx.lenient:
        assert dist < 1.0, f"bf16 mel distance {dist} over gate"
    return out


# ---------------------------------------------------------------------------

def validate(directory: str, *, lenient: bool = False, audio: str = "", only=(),
             device="cuda", printer=print) -> dict:
    """Run the checks (all, or those named in `only`) on `directory`;
    returns {"results": {check: {"status", ...}}, "summary": {...}}."""
    from ..device import use_full_fp32

    ctx = Ctx(directory, lenient=lenient, audio=audio, device=device)
    use_full_fp32(ctx.device)
    only = set(only)
    results = {}
    n_fail = 0
    for name, fn in CHECKS:
        if only and name not in only:
            continue
        try:
            r = fn(ctx)
            results[name] = {"status": "PASS", **(r or {})}
            printer(f"PASS {name}: {json.dumps(r)}")
        except Skip as s:
            results[name] = {"status": "SKIP", "reason": str(s)}
            printer(f"SKIP {name}: {s}")
        except Exception as e:  # noqa: BLE001
            n_fail += 1
            results[name] = {"status": "FAIL", "error": f"{e}"}
            printer(f"FAIL {name}: {e}")
            traceback.print_exc()
    summary = {"checks": len(results),
               "pass": sum(1 for r in results.values() if r["status"] == "PASS"),
               "skip": sum(1 for r in results.values() if r["status"] == "SKIP"),
               "fail": n_fail, "lenient": lenient}
    return {"results": results, "summary": summary}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m rvc_maker_tpu_torch.tools.validate_real_weights")
    ap.add_argument("dir", help="directory of downloaded artifacts")
    ap.add_argument("--lenient", action="store_true",
                    help="structural checks only (synthetic stand-ins)")
    ap.add_argument("--audio", default="", help="real speech wav for quality gates")
    ap.add_argument("--only", default="", help="comma-separated check names")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = validate(args.dir, lenient=args.lenient, audio=args.audio,
                   only=filter(None, args.only.split(",")), device=args.device)
    print(json.dumps({"validate_real_weights": out["summary"]}))
    return 1 if out["summary"]["fail"] else 0


if __name__ == "__main__":
    sys.exit(main())
