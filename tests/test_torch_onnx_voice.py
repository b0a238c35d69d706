"""`.onnx` voice models in the port: JAX-exported (static and dynamic)
and port-exported graphs through the port's `OnnxVoiceModel` against
JAX `synthesizer.infer` (jitted) on the same weights and noise, rtol
1e-3 / atol 2e-4 (the JAX package's own ONNX bound); the port's export
against the JAX export's metadata and through the JAX executor; the
torch-convention graph; capacity overflow; and ConvertPipeline with the
`.onnx` against the JAX pipeline with the `.pth`, waveform <= 1e-3."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu.config import DataConfig, RVCConfig, TrainConfig
from rvc_maker_tpu.config import ModelConfig as JaxModelConfig
from rvc_maker_tpu.interop import onnx_proto as jproto
from rvc_maker_tpu.interop import onnx_voice as jvoice
from rvc_maker_tpu.interop.onnx_run import OnnxGraph as JaxGraph
from rvc_maker_tpu.interop.torch_export import export_synthesizer_pth
from rvc_maker_tpu.interop.torch_import import load_synthesizer_pth as jax_load_pth
from rvc_maker_tpu.models import synthesizer as jsyn
from rvc_maker_tpu_torch.config import ModelConfig
from rvc_maker_tpu_torch.interop import from_jax
from rvc_maker_tpu_torch.interop import onnx_proto as proto
from rvc_maker_tpu_torch.interop.onnx_export import export_onnx
from rvc_maker_tpu_torch.interop.onnx_voice import (OnnxVoiceModel, export_voice_model,
                                                    load_voice_model)
from torch_port_util import jax_noise, n, torch_threads  # noqa: F401

RTOL, ATOL = 1e-3, 2e-4
FRAMES = 24

JCFG = JaxModelConfig(
    spec_channels=129, segment_size=8, inter_channels=32, hidden_channels=32,
    filter_channels=64, n_heads=2, n_layers=1, kernel_size=3,
    resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)),
    upsample_rates=(4, 4, 2, 2), upsample_initial_channel=64,
    upsample_kernel_sizes=(8, 8, 4, 4), spk_embed_dim=4, gin_channels=16,
    sr=6400, use_f0=True, text_enc_hidden_dim=768)
CFG = ModelConfig(**dataclasses.asdict(JCFG))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    td = tmp_path_factory.mktemp("onnx_voice")
    tree = from_jax.random_synthesizer_tree(CFG, seed=3)
    pth = str(td / "model.pth")
    export_synthesizer_pth(jax.tree_util.tree_map(jnp.asarray, tree),
                           RVCConfig(version="v2", train=TrainConfig(), data=DataConfig(),
                                     model=JCFG), pth, epoch=7, step=123, author="t")
    out = {"pth": pth, "jax_static": str(td / "jax_static.onnx"),
           "jax_dynamic": str(td / "jax_dynamic.onnx"), "port": str(td / "port.onnx"),
           "port_static": str(td / "port_static.onnx")}
    jvoice.export_voice_model(pth, out["jax_static"], max_frames=FRAMES, dynamic=False)
    jvoice.export_voice_model(pth, out["jax_dynamic"])
    export_voice_model(pth, out["port"])
    export_voice_model(pth, out["port_static"], max_frames=FRAMES, dynamic=False)
    return out


@pytest.fixture(scope="module")
def jax_infer(files):
    params, cfg, _ = jax_load_pth(files["pth"])
    fn = jax.jit(lambda *a: jsyn.infer(params, cfg, *a)[0][:, :, 0])
    return lambda *a: np.asarray(fn(*(jnp.asarray(x) for x in a)))


def _inputs(b, t, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, t, 768).astype(np.float32) * 0.3, np.full(b, t, np.int32),
            rs.randint(1, 255, (b, t)).astype(np.int32),
            rs.uniform(100, 300, (b, t)).astype(np.float32), np.asarray([1, 3][:b], np.int32),
            rs.randn(b, t, CFG.inter_channels).astype(np.float32),
            rs.randn(b, t * CFG.upp, 1).astype(np.float32))


def _synth(vm, args):
    return n(vm.synth(*(torch.as_tensor(a) for a in args)))


@pytest.mark.parametrize("which,t", [("jax_static", FRAMES), ("jax_dynamic", 24),
                                     ("jax_dynamic", 37), ("port", 24), ("port", 37),
                                     ("port_static", FRAMES)])
def test_graph_matches_jax_infer(files, jax_infer, which, t):
    """Both packages' static graphs at their capacity, their dynamic
    graphs at two lengths, each through the port's executor."""
    vm, cfg, info = load_voice_model(files[which], device="cpu")
    assert isinstance(vm, OnnxVoiceModel) and cfg == CFG and info["epoch"] == 7
    assert vm.dynamic == (not which.endswith("static"))
    args = _inputs(2, t, seed=t)
    got = _synth(vm, args)
    ref = jax_infer(*args)
    assert got.shape == ref.shape == (2, t * CFG.upp)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_port_export_metadata_equals_jax_export(files):
    def md(path):
        m = jproto.load_model(path)
        return {e.key: e.value for e in m.metadata_props}, m

    port, pm = md(files["port"])
    ref, jm = md(files["jax_dynamic"])
    assert set(port) == set(ref) == {"model_info", "config_list", "max_frames", "min_frames",
                                     "layout"}
    pi, ri = json.loads(port.pop("model_info")), json.loads(ref.pop("model_info"))
    pi.pop("creation_date"), ri.pop("creation_date")
    assert pi == ri and port == ref
    assert [vi.name for vi in pm.graph.input] == jvoice.INPUT_NAMES_F0
    dims = {vi.name: vi.type.tensor_type.shape.dim for vi in pm.graph.input}
    assert dims["phone"][1].dim_param == "t" and not dims["phone"][1].dim_value
    assert dims["sine_noise"][1].dim_param == f"{CFG.upp}*t"
    assert [vi.name for vi in pm.graph.output] == ["audio"]


def test_jax_executor_runs_port_export(files, jax_infer):
    """The file format holds both ways: the JAX package's loader takes
    the port's export and its executor runs it."""
    vm = jvoice.OnnxVoiceModel(files["port"])
    assert vm.dynamic and vm.min_frames == 21 and vm.cfg.inter_channels == CFG.inter_channels
    args = _inputs(1, 22, seed=5)
    names = jvoice.INPUT_NAMES_F0
    got = np.asarray(JaxGraph(files["port"]).run(dict(zip(names, args)))[0])
    np.testing.assert_allclose(got, jax_infer(*args), rtol=RTOL, atol=ATOL)


def test_short_chunk_pads_to_band_minimum(files, jax_infer):
    vm, _, _ = load_voice_model(files["port"], device="cpu")
    t = 17
    args = _inputs(1, t, seed=9)
    got = _synth(vm, args)
    assert got.shape == (1, t * CFG.upp)
    guard = 4 * CFG.upp  # the pad's receptive field at the tail
    np.testing.assert_allclose(got[:, :-guard], jax_infer(*args)[:, :-guard],
                               rtol=RTOL, atol=ATOL)


def test_static_capacity_overflow_raises(files):
    vm, _, _ = load_voice_model(files["jax_static"], device="cpu")
    with pytest.raises(ValueError, match="max_frames"):
        _synth(vm, _inputs(1, FRAMES + 8, seed=0))


def test_torch_convention_graph_loads_and_runs(tmp_path):
    """model_info only, rnd (1, inter, T), no sine_noise, audio with a
    channel axis: the config comes from the preset."""
    from rvc_maker_tpu_torch.config import preset

    cfg = preset("v2", 32000).model
    T, emb, inter, upp = 20, 768, cfg.inter_channels, cfg.upp

    def stub(phone, phone_lengths, ds, rnd, pitch, pitchf):
        v = phone.mean() + rnd.mean() + pitchf.mean() * 1e-3 + ds.sum() * 0.0
        return v.expand(1, 1, T * upp)

    model = export_onnx(
        stub, (torch.zeros(1, T, emb), torch.tensor([T]), torch.zeros(1, dtype=torch.long),
               torch.zeros(1, inter, T), torch.zeros(1, T, dtype=torch.long),
               torch.zeros(1, T)),
        input_names=["phone", "phone_lengths", "ds", "rnd", "pitch", "pitchf"],
        output_names=["audio"], dynamic_axes={"phone": {1: "t"}, "rnd": {2: "t"},
                                              "pitch": {1: "t"}, "pitchf": {1: "t"}},
        metadata={"model_info": json.dumps({"sr": 32000, "f0": 1, "version": "v2",
                                            "text_enc_hidden_dim": 768})})
    path = str(tmp_path / "torch_style.onnx")
    proto.save_model(model, path)
    vm, vm_cfg, _ = load_voice_model(path, device="cpu")
    assert vm.torch_layout and vm.dynamic
    assert vm_cfg.sr == 32000 and vm_cfg.inter_channels == inter and vm_cfg.upp == upp
    rs = np.random.RandomState(0)
    phone = rs.randn(1, T, emb).astype(np.float32)
    z = rs.randn(1, T, inter).astype(np.float32)
    pitchf = rs.uniform(100, 300, (1, T)).astype(np.float32)
    wav = _synth(vm, (phone, np.asarray([T]), rs.randint(1, 255, (1, T)), pitchf,
                      np.asarray([0]), z, rs.randn(1, T * upp, 1).astype(np.float32)))
    want = phone.mean() + z.mean() + pitchf.mean() * 1e-3
    np.testing.assert_allclose(wav, np.full((1, T * upp), want), rtol=1e-4, atol=1e-5)


def test_convert_pipeline_onnx_matches_jax_pth(files):
    """The port's ConvertPipeline with the port-exported `.onnx` against
    the JAX pipeline with the `.pth` it came from, on the JAX draws."""
    from rvc_maker_tpu.pipelines.convert import ConvertPipeline as JaxPipeline
    from rvc_maker_tpu.pipelines.convert import ConvertSettings as JaxSettings
    from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline, ConvertSettings

    hubert = from_jax.random_hubert_tree(seed=1, n_layers=2)
    params, cfg, _ = jax_load_pth(files["pth"])
    jax_pipe = JaxPipeline(params, cfg, jax.tree_util.tree_map(jnp.asarray, hubert),
                           version="v2", compute_dtype=None)
    vm, vm_cfg, _ = load_voice_model(files["port"], device="cpu")
    port = ConvertPipeline(vm, vm_cfg, from_jax.hubert_from_jax(hubert), version="v2",
                           device="cpu")
    rs = np.random.RandomState(5)
    audio = (rs.randn(2, 6400) * 0.1).astype(np.float32)
    lengths = np.array([6400, 5000])
    knobs = dict(pitch=0, index_rate=0.0, protect=0.5, f0_method="yin")
    wav_j, _ = jax_pipe.convert_batch(audio, lengths, 0, JaxSettings(**knobs))
    p_len = port.frames(audio.shape[1])
    z, s = jax_noise(2, p_len, CFG.inter_channels, CFG.upp)
    wav, _ = port.convert_batch(audio, lengths, 0, ConvertSettings(**knobs),
                                z_noise=torch.as_tensor(z), noise={"sine": torch.as_tensor(s)})
    err = float(np.abs(n(wav) - np.asarray(wav_j)).max())
    assert wav.shape == tuple(np.shape(wav_j)) and np.isfinite(n(wav)).all()
    assert err <= 1e-3, err
