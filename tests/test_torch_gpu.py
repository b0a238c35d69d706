"""Tests of the port that need a CUDA card; here, without one, they skip.

This file imports no JAX, so that it runs on a machine with the card
and PyTorch alone:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(`--noconftest`: tests/conftest.py sets up JAX for the JAX package's
tests.)  TF32 is off, so that fp32 convolutions and matmuls on the card
are full fp32, as on the CPU."""

import numpy as np
import pytest
import torch

from rvc_maker_tpu_torch.config import ModelConfig
from rvc_maker_tpu_torch.interop import from_jax
from rvc_maker_tpu_torch.ops import int8_conv as tq
from rvc_maker_tpu_torch.ops import resblock as trb
from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline, ConvertSettings
from torch_port_util import (BF16_ULPS, assert_grads_close, bf16_ulp, n, packed_resblock,
                             resblock_params, resblock_x, t)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("C,T", [(256, 1000), (128, 3000), (64, 5000),
                                 (32, 7000), (16, 9000)])
@pytest.mark.parametrize("k", [3, 7, 11])
def test_kernel_matches_plain_on_card(cuda, C, T, k):
    dils = (1, 3, 5)
    p = resblock_params(C + k, k, C, 3)
    args = [a.to(cuda) for a in packed_resblock(p)]
    x = t(resblock_x(T, C)).transpose(1, 2).contiguous().to(cuda)
    ref = trb._resblock(x, *args, kernel_size=k, dilations=dils)
    before = trb.resblock_launches
    got = trb.fused_resblock(x, *args, kernel_size=k, dilations=dils)
    torch.cuda.synchronize()
    assert trb.resblock_launches == before + len(dils)
    err = (got - ref).abs().max().item()
    assert err <= 1e-4 * max(1.0, ref.abs().max().item()), err


TC_TT = {256: 64, 128: 128, 64: 256, 32: 512, 16: 1024}   # resblock_tc.cu rows per block


def _tc_case(cuda, C, k, T, b=3, seed=0):
    """The tensor-core route at (C, k, T), dilations (1, 3, 5), against the
    plain chain: <= 1e-4 x max(1, |ref|max); 3 launches of resblock_tc."""
    dils = (1, 3, 5)
    p = resblock_params(seed + C + k, k, C, 3)
    args = [a.to(cuda) for a in packed_resblock(p)]
    x = t(resblock_x(T, C, b=b)).transpose(1, 2).contiguous().to(cuda)
    assert trb._route("cuda", x.dtype, C) == "tc"
    ref = trb._resblock(x, *args, kernel_size=k, dilations=dils)
    before, before_tc = trb.resblock_launches, trb.resblock_tc_launches
    got = trb.fused_resblock(x, *args, kernel_size=k, dilations=dils)
    torch.cuda.synchronize()
    assert trb.resblock_tc_launches == before_tc + len(dils)
    assert trb.resblock_launches == before + len(dils)
    err = (got - ref).abs().max().item()
    assert torch.isfinite(got).all() and err <= 1e-4 * max(1.0, ref.abs().max().item()), err
    return got, ref


@pytest.mark.gpu
@pytest.mark.parametrize("C", trb.TC_WIDTHS)
@pytest.mark.parametrize("k", [3, 7, 11])
def test_tc_kernel_matches_plain_on_card(cuda, C, k):
    """T is not a multiple of the block's rows: 2 full tiles and a ragged one."""
    _tc_case(cuda, C, k, 2 * TC_TT[C] + 37)


@pytest.mark.gpu
@pytest.mark.parametrize("C", trb.TC_WIDTHS)
@pytest.mark.parametrize("T", [1, 7])
def test_tc_kernel_short_sequence_on_card(cuda, C, T):
    """T shorter than one tile and than the k = 11 halo."""
    _tc_case(cuda, C, 11, T)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [256, 16])
def test_tc_kernel_edge_rows_on_card(cuda, C):
    """One row past a tile: the last block holds a single row; the rows
    at both sequence edges and at the tile seam match on their own."""
    T = TC_TT[C] + 1
    got, ref = _tc_case(cuda, C, 7, T)
    tol = 1e-4 * max(1.0, ref.abs().max().item())
    for rows in (slice(0, 6), slice(TC_TT[C] - 6, TC_TT[C] + 1)):
        assert (got[..., rows] - ref[..., rows]).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tc,tc_bf16", [(torch.float32, 3, 0), (torch.bfloat16, 0, 3)],
                         ids=["fp32", "bf16"])
def test_tc_route_counts_on_card(cuda, dtype, tc, tc_bf16):
    """fp32 launches resblock_tc, bf16 resblock_tc_bf16; resblock_launches
    counts both."""
    k, dils, C, T = 3, (1, 3, 5), 128, 300
    p = resblock_params(8, k, C, 3)
    x = t(resblock_x(T, C, b=1)).transpose(1, 2).contiguous().to(cuda)
    args = [a.to(cuda) for a in packed_resblock(p)]
    before = (trb.resblock_launches, trb.resblock_tc_launches, trb.resblock_tc_bf16_launches)
    trb.fused_resblock(x.to(dtype), *[a.to(dtype) for a in args], kernel_size=k,
                       dilations=dils)
    torch.cuda.synchronize()
    assert trb.resblock_launches - before[0] == 3
    assert trb.resblock_tc_launches - before[1] == tc
    assert trb.resblock_tc_bf16_launches - before[2] == tc_bf16


def _bf16_tol(ref) -> float:
    return BF16_ULPS * bf16_ulp(ref.abs().max().item())


def _bf16_case(cuda, C, k, T, b=2):
    dils = (1, 3, 5)
    p = resblock_params(C + 2 * k, k, C, 3)
    args = [a.to(cuda).bfloat16() for a in packed_resblock(p)]
    x = t(resblock_x(T, C, b=b)).transpose(1, 2).contiguous().to(cuda).bfloat16()
    ref = trb._resblock(x, *args, kernel_size=k, dilations=dils).float()
    return x, args, dils, ref


@pytest.mark.gpu
@pytest.mark.parametrize("C", trb.SUPPORTED_C)
@pytest.mark.parametrize("k", [3, 7, 11])
def test_tc_bf16_kernel_matches_plain_on_card(cuda, C, k):
    """The bf16 route (csrc/resblock_tc_bf16.cu) at every width, T two
    full tiles and a ragged one, against the bf16 plain chain on the same
    inputs: max abs <= 4 bf16 ulps of |ref|max; 3 launches of it."""
    x, args, dils, ref = _bf16_case(cuda, C, k, 2 * TC_TT[C] + 37)
    assert trb._route("cuda", x.dtype, C) == "tc_bf16"
    before = trb.resblock_tc_bf16_launches
    got = trb.fused_resblock(x, *args, kernel_size=k, dilations=dils)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and trb.resblock_tc_bf16_launches == before + 3
    err = (got.float() - ref).abs().max().item()
    assert torch.isfinite(got).all() and err <= _bf16_tol(ref), err


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["tc_bf16", "fma"])
@pytest.mark.parametrize("C,T", [(256, 1), (16, 7), (64, 257)])
def test_bf16_kernels_called_directly_on_card(cuda, route, C, T):
    """Each bf16 kernel called directly, not through `_route`
    (resblock.cu, on no route now, through `_fma_resblock`), at k = 11 on
    sequences shorter than a tile and than the halo, and one row past a
    tile: within 4 bf16 ulps of the bf16 plain chain."""
    x, args, dils, ref = _bf16_case(cuda, C, 11, T, b=3)
    got = (trb._fma_resblock(x, *args, kernel_size=11, dilations=dils) if route == "fma"
           else trb._launch_steps(route, x, *args, 11, dils)[-1])
    torch.cuda.synchronize()
    err = (got.float() - ref).abs().max().item()
    assert torch.isfinite(got).all() and err <= _bf16_tol(ref), err


@pytest.mark.gpu
def test_tc_autograd_matches_plain_on_card(cuda):
    """Gradients through the tensor-core forward at C = 128 match
    torch.autograd through the plain chain at the kernel's slopes."""
    k, dils, C, T = 7, (1, 3, 5), 128, 1000
    p = resblock_params(21, k, C, 3)
    x = t(resblock_x(T, C)).transpose(1, 2).contiguous().to(cuda)
    cot = torch.randn(x.shape, generator=torch.Generator().manual_seed(2)).to(cuda)
    leaves = [v.requires_grad_(True) for v in [x] + [a.to(cuda) for a in packed_resblock(p)]]
    before_tc = trb.resblock_tc_launches
    out = trb.fused_resblock(*leaves, kernel_size=k, dilations=dils)
    assert out.grad_fn is not None and trb.resblock_tc_launches == before_tc + len(dils)
    _assert_grads_at_kernel_slopes(out, leaves, cot, k, dils)


@pytest.mark.gpu
def test_kernel_bf16_correlates_on_card(cuda):
    """The bf16 route (resblock_tc_bf16) follows the fp32 plain chain:
    correlation > 0.99."""
    k, dils, C, T = 3, (1, 3, 5), 64, 600
    p = resblock_params(7, k, C, 3)
    x = t(resblock_x(T, C, b=1)).transpose(1, 2).contiguous().to(cuda)
    args = [a.to(cuda) for a in packed_resblock(p)]
    ref = trb._resblock(x, *args, kernel_size=k, dilations=dils)
    before = trb.resblock_tc_bf16_launches
    got = trb.fused_resblock(x.bfloat16(), *[a.bfloat16() for a in args],
                             kernel_size=k, dilations=dils).float()
    assert trb.resblock_tc_bf16_launches == before + len(dils)
    corr = np.corrcoef(n(got).ravel(), n(ref).ravel())[0, 1]
    assert corr > 0.99, corr


@pytest.mark.gpu
@pytest.mark.parametrize("C,dil", [(96, 1), (64, trb.MAX_DILATION + 1)])
def test_kernel_rejects_unsupported_width(cuda, C, dil):
    k = 3
    x = torch.zeros(1, C, 100, device=cuda)
    w = torch.zeros(1, k, C, C, device=cuda)
    b = torch.zeros(1, C, device=cuda)
    with pytest.raises(ValueError, match="kernel takes"):
        trb.fused_resblock(x, w, b, w, b, kernel_size=k, dilations=(dil,))


@pytest.mark.gpu
def test_pipeline_card_matches_cpu(cuda):
    """A small model (decode stages C = 128/64/32/16, all kernel widths)
    through convert_batch on the card and on the CPU, same noise."""
    cfg = ModelConfig(
        spec_channels=129, segment_size=8, inter_channels=32, hidden_channels=32,
        filter_channels=64, n_heads=2, n_layers=1, kernel_size=3,
        upsample_rates=(4, 4, 2, 2), upsample_initial_channel=256,
        upsample_kernel_sizes=(8, 8, 4, 4), spk_embed_dim=4, gin_channels=16,
        sr=6400, text_enc_hidden_dim=768)
    synth = from_jax.synthesizer_from_jax(from_jax.random_synthesizer_tree(cfg, 0), cfg)
    hubert = from_jax.hubert_from_jax(from_jax.random_hubert_tree(1, n_layers=2))
    index = np.random.RandomState(2).randn(200, 768).astype(np.float32)
    rs = np.random.RandomState(3)
    audio = (0.3 * np.sin(2 * np.pi * 200 * np.arange(32000) / 16000)
             + 0.01 * rs.randn(32000)).astype(np.float32)[None]
    lengths = np.array([32000])
    rmvpe = from_jax.rmvpe_from_jax(from_jax.random_rmvpe_tree(
        4, widths=(4, 8, 16, 32, 64), inter_width=128))
    outs = {}
    for dev in ("cpu", "cuda"):
        pipe = ConvertPipeline(synth, cfg, hubert, rmvpe_params=rmvpe,
                               index_vectors=index, device=dev)
        z, noise = pipe.draw_noise(1, pipe.frames(audio.shape[1]),
                                   torch.Generator().manual_seed(5))
        before = trb.resblock_launches
        wav, _ = pipe.convert_batch(audio, lengths, 0, ConvertSettings(index_rate=0.5),
                                    z_noise=z, noise=noise)
        launched = trb.resblock_launches - before
        assert launched == (0 if dev == "cpu" else 4 * 3 * 3), launched
        outs[dev] = n(wav)
    err = np.abs(outs["cuda"] - outs["cpu"]).max()
    assert np.isfinite(outs["cuda"]).all() and err <= 1e-3, err


def _assert_grads_at_kernel_slopes(out, leaves, cot, k, dils):
    """The gradients of `out` (fused_resblock on the card) against
    torch.autograd through the plain chain with its leaky-ReLU slopes
    pinned at the kernel's step inputs (`_resblock_at_slopes`: the kernel
    agrees with the plain chain to rounding, and leaky_relu's derivative
    jumps at 0).  A slope may differ only where the pre-activation is of
    rounding size; each gradient <= 1e-4 x max(1, |ref|max)."""
    got = torch.autograd.grad(out, leaves, cot)
    xs = trb._forward_steps(*[v.detach() for v in leaves], k, dils)
    ref_out, worst = trb._resblock_at_slopes(*leaves, kernel_size=k, dilations=dils,
                                             step_inputs=xs[:-1])
    assert worst <= 1e-4 * max(1.0, out.abs().max().item()), worst
    ref = torch.autograd.grad(ref_out, leaves, cot)
    for a, r in zip(got, ref):
        assert (a - r).abs().max().item() <= 1e-4 * max(1.0, r.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("k", [3, 7, 11])
def test_kernel_autograd_matches_plain_on_card(cuda, k):
    """fused_resblock on a CUDA tensor that requires grad returns a
    tensor with a grad_fn; its gradients in x and the packed weights
    match torch.autograd through the plain chain at the kernel's slopes."""
    dils, C, T = (1, 3, 5), 64, 3000
    p = resblock_params(3 * k, k, C, 3)
    x = t(resblock_x(T, C)).transpose(1, 2).contiguous().to(cuda)
    cot = torch.randn(x.shape, generator=torch.Generator().manual_seed(k)).to(cuda)
    leaves = [v.requires_grad_(True) for v in [x] + [a.to(cuda) for a in packed_resblock(p)]]
    before = trb.resblock_launches
    out = trb.fused_resblock(*leaves, kernel_size=k, dilations=dils)
    assert out.grad_fn is not None and trb.resblock_launches == before + len(dils)
    _assert_grads_at_kernel_slopes(out, leaves, cot, k, dils)


@pytest.mark.gpu
def test_train_step_card_matches_cpu(cuda):
    """One train step of a narrow model (decode C = 128..16, k = 3/7/11)
    from the same state and explicit noise on the card and on the CPU:
    each loss term <= 1e-4 relative, each gradient leaf <= 1e-3 x its
    max |g| (an exact-zero gradient is rounding noise on both)."""
    from rvc_maker_tpu_torch.config import DataConfig, RVCConfig, TrainConfig
    from rvc_maker_tpu_torch.pipelines import train as tr

    cfg = RVCConfig(
        version="v2", train=TrainConfig(segment_size=8 * 64),
        data=DataConfig(sample_rate=6400, filter_length=256, hop_length=64, win_length=256,
                        n_mel_channels=32),
        model=ModelConfig(spec_channels=129, segment_size=8, inter_channels=32,
                          hidden_channels=32, filter_channels=64, n_heads=2, n_layers=1,
                          kernel_size=3, upsample_rates=(4, 4, 2, 2),
                          upsample_initial_channel=256, upsample_kernel_sizes=(8, 8, 4, 4),
                          spk_embed_dim=4, gin_channels=16, sr=6400, text_enc_hidden_dim=96))
    rs = np.random.RandomState(1)
    b, tl = 2, 20
    lengths = np.array([tl, 12], np.int32)
    batch = tr.Batch(phone=rs.randn(b, tl, 96).astype(np.float32), phone_lengths=lengths,
                     pitch=rs.randint(1, 256, (b, tl)),
                     pitchf=(rs.rand(b, tl) * 200 + 80).astype(np.float32),
                     spec=np.abs(rs.randn(b, tl, 129)).astype(np.float32),
                     spec_lengths=lengths, wave=(rs.randn(b, tl * 64, 1) * 0.1).astype(np.float32),
                     sid=np.array([0, 3]))
    noise = dict(post_noise=rs.randn(b, tl, 32).astype(np.float32),
                 ids_slice=np.array([5, 2], np.int32),
                 sine=rs.randn(b, 8 * 64, 1).astype(np.float32))
    params_g = from_jax.synthesizer_from_jax(from_jax.random_synthesizer_tree(cfg.model, 2),
                                             cfg.model, train=True)
    params_d = from_jax.discriminator_from_jax(from_jax.random_discriminator_tree("v2", 16, 3))
    out = {}
    for dev in ("cpu", "cuda"):
        state = tr.init_state(cfg, params_g, params_d, device=dev, disc_width_div=16)
        out[dev] = tr.make_train_step(cfg, 16)(
            state, batch.to(dev), keep_grads=True,
            noise=dict(post_noise=torch.as_tensor(noise["post_noise"], device=dev),
                       ids_slice=torch.as_tensor(noise["ids_slice"], device=dev),
                       dec_noise={"sine": torch.as_tensor(noise["sine"], device=dev)}))
    for k in ("loss_g", "loss_d", "loss_mel", "loss_kl", "loss_fm", "loss_adv"):
        np.testing.assert_allclose(float(out["cuda"][k]), float(out["cpu"][k]), rtol=1e-4)
    for name in ("grads_g", "grads_d"):
        assert_grads_close(out["cuda"][name], out["cpu"][name], name)



@pytest.mark.gpu
@pytest.mark.parametrize("kind,launches", [("plain", 36), ("mrf", 36), ("refinegan", 0)])
def test_decoder_full_width_card_matches_cpu(cuda, kind, launches):
    """Each decoder at the full v2 / 48 kHz width (stages C = 256..32) on
    100 frames (1 s), card against CPU on the same weights and noise:
    waveform <= 1e-3.  The f0-less and MRF decodes launch resblock_tc 36
    times; RefineGAN's resblocks take leaky-ReLU 0.2, which the kernel
    (slope 0.1) does not compute, so it launches none."""
    from rvc_maker_tpu_torch.config import preset
    from rvc_maker_tpu_torch.device import tree_to
    from rvc_maker_tpu_torch.models import synthesizer as tsyn
    from rvc_maker_tpu_torch.models import vocoders as tvoc

    vocoder = {"mrf": "MRF HiFi-GAN", "refinegan": "RefineGAN"}.get(kind, "Default")
    cfg = preset("v2", 48000, vocoder=vocoder, pitch_guidance=kind != "plain").model
    assert tsyn.decoder_kind(cfg) == kind
    dec = from_jax.synthesizer_from_jax(from_jax.random_synthesizer_tree(cfg, 0), cfg)["dec"]
    rs = np.random.RandomState(1)
    T = 100
    x = t((rs.randn(1, T, cfg.inter_channels) * 0.5).astype(np.float32))
    f0 = t(rs.uniform(100, 300, (1, T)).astype(np.float32))
    g = t((rs.randn(1, 1, cfg.gin_channels) * 0.3).astype(np.float32))
    noise = tsyn.decoder_noise(cfg, 1, T, torch.Generator().manual_seed(2), "cpu")
    outs = {}
    for dev in (torch.device("cpu"), cuda):
        p, nz, a = tree_to(dec, dev), tree_to(noise, dev), tree_to([x, f0, g], dev)
        before = trb.resblock_tc_launches
        with torch.inference_mode():
            if kind == "plain":
                o = tsyn.generator(p, cfg, a[0], a[2])
            elif kind == "mrf":
                o = tvoc.mrf_hifigan(p, cfg, *a, nz["source"], nz["rand_ini"])
            else:
                o = tvoc.refinegan(p, cfg, *a, nz["source"], nz["adain"], nz["rand_ini"])
        torch.cuda.synchronize()
        assert trb.resblock_tc_launches - before == (launches if dev.type == "cuda" else 0)
        outs[dev.type] = n(o)
    err = np.abs(outs["cuda"] - outs["cpu"]).max()
    print(f"{kind}: card vs CPU waveform max abs err {err:.3e}")
    assert outs["cuda"].shape == (1, T * cfg.upp, 1)
    assert np.isfinite(outs["cuda"]).all() and err <= 1e-3, err


@pytest.mark.gpu
def test_interp_linear_card_matches_cpu(cuda):
    """RefineGAN's f0 upsampling at its full size, 2 x 998 frames to
    479,040 samples: the card's index arithmetic against the CPU's,
    within 1e-5 x max|x|."""
    from rvc_maker_tpu_torch.models import vocoders as tvoc

    x = t(np.random.RandomState(0).uniform(80, 300, (2, 1, 998)).astype(np.float32))
    cpu = tvoc.interp_linear(x, 998 * 480)
    card = tvoc.interp_linear(x.to(cuda), 998 * 480).cpu()
    err = (card - cpu).abs().max().item()
    print(f"interp_linear 479,040 samples: card vs CPU max abs diff {err:.3e}")
    assert err <= 1e-5 * x.abs().max().item(), err


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["yin", "fcpe", "fcpe-legacy", "crepe-tiny"])
def test_device_f0_method_card_matches_cpu(cuda, method):
    """Each device F0 method at a narrow width (FCPE 128 wide, 2 layers;
    CREPE tiny), card against CPU on 2 s: voicing equal, f0 <= 1e-2 Hz
    where both are voiced, and the waveform of the card's pipeline given
    the CPU's f0 <= 1e-3; the card's decode launches resblock_tc."""
    cfg = ModelConfig(
        spec_channels=129, segment_size=8, inter_channels=32, hidden_channels=32,
        filter_channels=64, n_heads=2, n_layers=1, kernel_size=3,
        upsample_rates=(4, 4, 2, 2), upsample_initial_channel=256,
        upsample_kernel_sizes=(8, 8, 4, 4), spk_embed_dim=4, gin_channels=16,
        sr=6400, text_enc_hidden_dim=768)
    tree = from_jax.random_synthesizer_tree(cfg, 0)
    for u in tree["dec"]["ups"]:
        u["w"] *= 20.0
    crepe = from_jax.random_crepe_tree(4, "tiny")
    crepe["classifier"]["w"] *= 8.0
    kw = dict(synth_params=from_jax.synthesizer_from_jax(tree, cfg), model_cfg=cfg,
              hubert_params=from_jax.hubert_from_jax(from_jax.random_hubert_tree(1, n_layers=2)),
              fcpe_params=from_jax.fcpe_from_jax(from_jax.random_fcpe_tree(
                  3, 128, 2, legacy=method == "fcpe-legacy")),
              crepe_params=from_jax.crepe_from_jax(crepe))
    tt = np.arange(32000) / 16000
    audio = (0.3 * np.sin(2 * np.pi * 220 * tt * (1 + 0.02 * np.sin(2 * np.pi * 3 * tt)))
             + 0.01 * np.random.RandomState(3).randn(32000)).astype(np.float32)[None]
    lengths = np.array([32000])
    settings = ConvertSettings(f0_method=method)
    pipes = {dev: ConvertPipeline(**kw, device=dev) for dev in ("cpu", "cuda")}
    z, noise = pipes["cpu"].draw_noise(1, pipes["cpu"].frames(32000),
                                       torch.Generator().manual_seed(5))
    f0 = {dev: p._f0(torch.as_tensor(audio, device=p.device), settings).cpu().numpy()[0]
          for dev, p in pipes.items()}
    wav = {}
    for dev, p in pipes.items():
        p._f0 = lambda a, s, d=p.device: torch.as_tensor(f0["cpu"][None], device=d)
        before = trb.resblock_tc_launches
        w, _ = p.convert_batch(audio, lengths, 0, settings, z_noise=z, noise=noise)
        assert trb.resblock_tc_launches - before == (0 if dev == "cpu" else 4 * 3 * 3)
        wav[dev] = n(w)
    a, b = f0["cpu"], f0["cuda"]
    both = (a > 0) & (b > 0)
    f0_err = float(np.abs(a - b)[both].max())
    err = float(np.abs(wav["cpu"] - wav["cuda"]).max())
    print(f"{method}: f0 card vs CPU {f0_err:.3e} Hz on {int(both.sum())} voiced frames, "
          f"waveform on the CPU's f0 {err:.3e}")
    np.testing.assert_array_equal(a > 0, b > 0)
    assert both.any() and f0_err <= 1e-2
    assert np.isfinite(wav["cuda"]).all() and err <= 1e-3


def _narrow_cfg():
    """Decode stages C = 128/64/32/16, every width the kernels take."""
    return ModelConfig(
        spec_channels=129, segment_size=8, inter_channels=32, hidden_channels=32,
        filter_channels=64, n_heads=2, n_layers=1, kernel_size=3,
        upsample_rates=(4, 4, 2, 2), upsample_initial_channel=256,
        upsample_kernel_sizes=(8, 8, 4, 4), spk_embed_dim=4, gin_channels=16,
        sr=6400, text_enc_hidden_dim=768)


def _counts():
    """The resblock launch counts: all, resblock_tc, resblock_tc_bf16."""
    return trb.resblock_launches, trb.resblock_tc_launches, trb.resblock_tc_bf16_launches


def _loud_synth(cfg, seed=0):
    tree = from_jax.random_synthesizer_tree(cfg, seed)
    for u in tree["dec"]["ups"]:
        u["w"] *= 20.0
    return from_jax.synthesizer_from_jax(tree, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_served_convert_matches_direct_on_card(cuda, tmp_path, monkeypatch, precision):
    """One /api/convert on the card in each precision: the response
    equals the direct convert_utterance of the server's pipeline within 1
    int16 step, and its decode launched the precision's kernel (fp32:
    36 resblock_tc; bf16: 36 resblock_tc_bf16; no other)."""
    import base64
    import http.client
    import io
    import json
    import threading
    from http.server import ThreadingHTTPServer

    from scipy.io import wavfile

    from rvc_maker_tpu_torch.app import server as srv
    from rvc_maker_tpu_torch.config import RVCConfig
    from rvc_maker_tpu_torch.interop.pth import export_synthesizer_pth
    from torch_port_util import hubert_state_dict

    cfg = _narrow_cfg()
    files = dict(model=str(tmp_path / "voice.pth"), embedder=str(tmp_path / "hubert.pt"),
                 index=str(tmp_path / "total_fea.npy"))
    export_synthesizer_pth(_loud_synth(cfg), RVCConfig(version="v2", model=cfg), files["model"])
    torch.save({"model": hubert_state_dict(from_jax.random_hubert_tree(1, n_layers=2))},
               files["embedder"])
    np.save(files["index"], np.random.RandomState(2).randn(200, 768).astype(np.float32))
    monkeypatch.setattr(srv, "SETTINGS_PATH", str(tmp_path / "settings.json"))
    monkeypatch.setitem(srv._SETTINGS, "precision", precision)
    monkeypatch.setitem(srv._STATE, "device", srv.resolve_device("cuda"))
    tt = np.arange(24000) / 16000
    buf = io.BytesIO()
    wavfile.write(buf, 16000, (0.3 * np.sin(2 * np.pi * 200 * tt) * 32767).astype(np.int16))
    req = dict(files, audio_b64=base64.b64encode(buf.getvalue()).decode(), f0_method="yin",
               index_rate=0.5)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv.Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        srv._get_pipeline(files["model"], files["index"], "", files["embedder"])
        before = _counts()
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=300)
        conn.request("POST", "/api/convert", body=json.dumps(req),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
        assert resp.status == 200, body
        launched = tuple(a - b for a, b in zip(_counts(), before))
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert launched == ((36, 36, 0) if precision == "fp32" else (36, 0, 36)), launched
    got = wavfile.read(io.BytesIO(base64.b64decode(body["audio_b64"])))[1]
    pipe = srv._get_pipeline(files["model"], files["index"], "", files["embedder"])
    assert pipe.compute_dtype is (torch.bfloat16 if precision == "bf16" else None)
    direct = pipe.convert_utterance(srv._request_audio(req), 0, ConvertSettings(
        index_rate=0.5, protect=0.33, f0_method="yin"))
    direct = (np.clip(direct, -1, 1) * 32767).astype(np.int16)
    assert got.shape == direct.shape and np.abs(got).max() > 1000
    assert np.abs(got.astype(np.int32) - direct).max() <= 1
    srv._STATE.update(pipeline=None, pipeline_key=None)


@pytest.mark.gpu
def test_bf16_pipeline_launches_fma_kernel_on_card(cuda):
    """bf16 resblocks on the card run csrc/resblock_tc_bf16.cu (36 launches
    per decode) and never resblock_tc or resblock.cu; the waveform comes
    back fp32 and follows the fp32 one (correlation > 0.98, max abs < 0.1,
    the JAX bf16 thresholds)."""
    cfg = _narrow_cfg()
    kw = dict(synth_params=_loud_synth(cfg), model_cfg=cfg, device="cuda",
              hubert_params=from_jax.hubert_from_jax(from_jax.random_hubert_tree(1, n_layers=2)))
    audio = (0.3 * np.sin(2 * np.pi * 200 * np.arange(32000) / 16000)).astype(np.float32)[None]
    settings = ConvertSettings(f0_method="yin", deterministic=True)
    wavs = {}
    for dtype in (None, torch.bfloat16):
        pipe = ConvertPipeline(**kw, compute_dtype=dtype)
        before = _counts()
        wav, pitchf = pipe.convert_batch(audio, [32000], 0, settings)
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(_counts(), before))
        assert launched == ((36, 0, 36) if dtype else (36, 36, 0)), launched
        assert wav.dtype == pitchf.dtype == torch.float32
        wavs[dtype] = n(wav)[0]
    a, b = wavs[None], wavs[torch.bfloat16]
    corr = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
    err = float(np.abs(a - b).max())
    print(f"bf16 vs fp32 on the card: corr {corr:.6f}, max abs {err:.3e}")
    assert np.isfinite(b).all() and corr > 0.98 and err < 0.1, (corr, err)


@pytest.mark.gpu
def test_server_set_device_turns_tf32_off_on_card(cuda):
    """PyTorch lets cuDNN run fp32 convolutions in TF32 by default; the
    server's set_device turns TF32 off for cuDNN and cuBLAS, and an fp32
    pipeline then gives the TF32-off waveform."""
    from rvc_maker_tpu_torch.app import server as srv

    cfg = _narrow_cfg()
    pipe = ConvertPipeline(_loud_synth(cfg), cfg, from_jax.hubert_from_jax(
        from_jax.random_hubert_tree(1, n_layers=2)), device="cuda")
    audio = (0.3 * np.sin(2 * np.pi * 200 * np.arange(16000) / 16000)).astype(np.float32)[None]
    settings = ConvertSettings(f0_method="yin", deterministic=True)
    ref = n(pipe.convert_batch(audio, [16000], 0, settings)[0])
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        srv.set_device("cuda")
        assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
        np.testing.assert_array_equal(n(pipe.convert_batch(audio, [16000], 0, settings)[0]), ref)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


W8A8_TT = {256: 64, 128: 128, 64: 256}     # csrc/conv1d_w8a8.cu time columns per block


def _w8a8_case(cuda, C, k, T, b=3, seed=None, fused=True):
    """bf16 input, residual and bias, int8 weights in the kernels' (k,
    C_out, C_in) layout, and x's own activation scale (after the leaky
    ReLU when fused)."""
    rs = np.random.RandomState(C + k + T if seed is None else seed)
    x = torch.as_tensor(rs.randn(b, C, T) * 0.5, dtype=torch.float32).to(cuda).bfloat16()
    res = torch.as_tensor(rs.randn(b, C, T) * 0.3, dtype=torch.float32).to(cuda).bfloat16()
    w_q, w_s = tq.quantize_weight(torch.as_tensor(rs.randn(k, C, C) * 0.05, dtype=torch.float32))
    w_q, w_s = w_q.permute(0, 2, 1).contiguous().to(cuda), w_s.to(cuda)
    bias = torch.as_tensor(rs.randn(C) * 0.1, dtype=torch.float32).to(cuda).bfloat16()
    a_s = tq.activation_scale(tq.lrelu(x) if fused else x).reshape(1)
    return x, res, w_q, w_s, bias, a_s


def _launches():
    return {name: getattr(tq, name + "_launches") for name in tq.KERNELS}


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", tq.KERNELS)
@pytest.mark.parametrize("C", tq.SUPPORTED_C)
@pytest.mark.parametrize("k,dil", [(3, 1), (7, 3), (11, 5)])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "lrelu+residual"])
def test_w8a8_kernel_matches_plain_on_card(cuda, kernel, C, k, dil, fused):
    """Each W8A8 kernel (csrc/conv1d_w8a8_ws.cu, the route, and
    csrc/conv1d_w8a8.cu, its first version) against the plain version on
    the card, T ragged against the blocks: the int32 accumulation is
    exact and the epilogue rounds as the plain version, so 0 elements
    differ; one launch of that kernel."""
    T = 2 * W8A8_TT[C] + 37
    x, res, w_q, w_s, b, a_s = _w8a8_case(cuda, C, k, T, seed=C + k, fused=fused)
    kw = dict(dilation=dil, apply_lrelu=fused, residual=res if fused else None)
    ref = tq._conv1d_w8a8_plain(x, w_q, w_s, b, a_s, **kw)
    before = _launches()
    got = tq.conv1d_w8a8_kernel(x, w_q, w_s, b, a_s, kernel=kernel, **kw)
    torch.cuda.synchronize()
    after = _launches()
    assert {n: after[n] - before[n] for n in tq.KERNELS} == {
        n: int(n == kernel) for n in tq.KERNELS}
    assert torch.isfinite(got.float()).all()
    assert int((got != ref).sum().item()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("C", tq.SUPPORTED_C)
@pytest.mark.parametrize("k", tq.SUPPORTED_K)
@pytest.mark.parametrize("dil", range(1, tq.MAX_DILATION + 1))
def test_w8a8_ws_every_shape_on_card(cuda, C, k, dil):
    """csrc/conv1d_w8a8_ws.cu, the route of a CUDA tensor, at every (C, K,
    dil) it takes: T of 1, below the taps' span, ragged against its tile,
    and a multiple of 8 over several tiles (its aligned path); B = 1 and
    3; the leaky ReLU and the residual on and off.  0 elements differ
    from the plain version, and each call is one launch of it."""
    tn = tq.WS_TILES[(C, k)][1]
    span = (k - 1) * dil
    for i, (b, T, fused) in enumerate([(1, 1, True), (3, max(1, span - 1), False),
                                       (1, tn + 13, False), (3, 2 * tn + 37, True),
                                       (3, 3 * tn + 8, True), (1, 2 * tn, False)]):
        x, res, w_q, w_s, bias, a_s = _w8a8_case(cuda, C, k, T, b=b, seed=C * 100 + k + i,
                                                 fused=fused)
        kw = dict(dilation=dil, apply_lrelu=fused, residual=res if fused else None)
        ref = tq._conv1d_w8a8_plain(x, w_q, w_s, bias, a_s, **kw)
        before = _launches()
        got = tq.conv1d_w8a8(x, w_q, w_s, bias, a_scale=a_s, **kw)
        torch.cuda.synchronize()
        after = _launches()
        assert (after["conv1d_w8a8_ws"] - before["conv1d_w8a8_ws"],
                after["conv1d_w8a8"] - before["conv1d_w8a8"]) == (1, 0)
        diff = int((got != ref).sum().item())
        assert diff == 0, (b, T, fused, diff)


@pytest.mark.gpu
def test_w8a8_ws_on_every_device_on_card(cuda):
    """csrc/conv1d_w8a8_ws.cu on each card in turn, the last first: its
    shared-memory attribute and occupancy are kept per device (a function
    attribute is per context), so a card launched on after another one
    still takes every width's tiles (each above 48 KB).  0 elements
    differ from the plain version on each card."""
    for dev in reversed(range(torch.cuda.device_count())):
        d = torch.device("cuda", dev)
        for C in tq.SUPPORTED_C:
            x, res, w_q, w_s, b, a_s = _w8a8_case(d, C, 11, 3 * tq.WS_TILES[(C, 11)][1] + 8)
            kw = dict(dilation=5, apply_lrelu=True, residual=res)
            ref = tq._conv1d_w8a8_plain(x, w_q, w_s, b, a_s, **kw)
            got = tq.conv1d_w8a8(x, w_q, w_s, b, a_scale=a_s, **kw)
            torch.cuda.synchronize(d)
            assert got.device == d and int((got != ref).sum().item()) == 0, (dev, C)


@pytest.mark.gpu
def test_w8a8_ws_smem_matches_mirror_on_card(cuda):
    """The library's shared memory at every (C, K, dil) is the Python
    mirror's (`ws_smem_bytes`), within a block's 232,448 bytes."""
    for c in tq.SUPPORTED_C:
        for k in tq.SUPPORTED_K:
            for d in range(1, tq.MAX_DILATION + 1):
                got = tq.smem_bytes(c, k, d)
                assert got == tq.ws_smem_bytes(c, k, d) <= tq.MAX_SMEM, (c, k, d, got)


@pytest.mark.gpu
def test_w8a8_ws_rejects_what_it_does_not_take_on_card(cuda):
    """A CUDA tensor of a shape the kernel does not take raises, with no
    fallback to the plain version: a width, a kernel size, a dilation, a
    dtype; and the library reports no shared memory for a shape it does
    not take."""
    x, res, w_q, w_s, b, a_s = _w8a8_case(cuda, 64, 3, 40)
    before = _launches()
    with pytest.raises(ValueError, match="C in"):
        tq.conv1d_w8a8(x[:, :32].contiguous(), w_q[:, :32, :32].contiguous(), w_s[:32],
                       b[:32], a_scale=a_s)
    with pytest.raises(ValueError, match="C in"):
        tq.conv1d_w8a8(x, torch.zeros((5, 64, 64), dtype=torch.int8, device=cuda), w_s, b,
                       a_scale=a_s)
    with pytest.raises(ValueError, match="dilations"):
        tq.conv1d_w8a8(x, w_q, w_s, b, a_scale=a_s, dilation=tq.MAX_DILATION + 1)
    with pytest.raises(ValueError, match="bf16"):
        tq.conv1d_w8a8(x.float(), w_q, w_s, b, a_scale=a_s)
    assert (tq.smem_bytes(32, 3, 1), tq.smem_bytes(64, 5, 1),
            tq.smem_bytes(64, 3, tq.MAX_DILATION + 1)) == (0, 0, 0)
    torch.cuda.synchronize()
    assert _launches() == before


@pytest.mark.gpu
def test_int8_pipeline_launches_w8a8_kernel_on_card(cuda, monkeypatch):
    """With RVC_TPU_INT8=1 a bf16 decode runs its C >= 64 stages on
    conv1d_w8a8_ws (2 stages x 3 resblocks x 3 dilations x 2 convs = 36
    launches; conv1d_w8a8, the first version, none) and its C = 32, 16
    stages on resblock_tc_bf16 (18), and
    stays within JAX's int8 gate of the bf16 decode (corr > 0.98, relative
    L2 < 0.2)."""
    cfg = _narrow_cfg()
    kw = dict(synth_params=_loud_synth(cfg), model_cfg=cfg, device="cuda",
              compute_dtype=torch.bfloat16,
              hubert_params=from_jax.hubert_from_jax(from_jax.random_hubert_tree(1, n_layers=2)))
    audio = (0.3 * np.sin(2 * np.pi * 200 * np.arange(32000) / 16000)).astype(np.float32)[None]
    settings = ConvertSettings(f0_method="yin", deterministic=True)
    wavs = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("RVC_TPU_INT8", flag)
        pipe = ConvertPipeline(**kw)
        assert (getattr(pipe.use_int8, "mode", None) == "static") == (flag == "1")
        before, before_q = _counts(), _launches()
        wav, _ = pipe.convert_batch(audio, [32000], 0, settings)
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(_counts(), before))
        assert launched == ((18, 0, 18) if flag == "1" else (36, 0, 36)), launched
        after_q = _launches()
        assert (after_q["conv1d_w8a8_ws"] - before_q["conv1d_w8a8_ws"],
                after_q["conv1d_w8a8"] - before_q["conv1d_w8a8"]) == (
                    (36, 0) if flag == "1" else (0, 0))
        wavs[flag] = n(wav)[0]
    a, b = wavs["1"], wavs["0"]
    corr = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
    rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    print(f"int8 vs bf16 on the card: corr {corr:.6f}, rel {rel:.4f}")
    assert np.isfinite(a).all() and corr > 0.98 and rel < 0.2, (corr, rel)


# -- two ranks on the card (rvc_maker_tpu_torch/parallel/) --------------------

def _narrow_rvc_config(text_dim=96):
    """A narrow model whose decode runs resblock_tc at every stage (C = 128
    .. 16, k = 3 / 7 / 11, dilations 1 / 3 / 5: 36 launches per decode)."""
    from rvc_maker_tpu_torch.config import DataConfig, RVCConfig, TrainConfig

    return RVCConfig(
        version="v2", train=TrainConfig(segment_size=8 * 64),
        data=DataConfig(sample_rate=6400, filter_length=256, hop_length=64, win_length=256,
                        n_mel_channels=32),
        model=ModelConfig(spec_channels=129, segment_size=8, inter_channels=32,
                          hidden_channels=32, filter_channels=64, n_heads=2, n_layers=1,
                          kernel_size=3, upsample_rates=(4, 4, 2, 2),
                          upsample_initial_channel=256, upsample_kernel_sizes=(8, 8, 4, 4),
                          spk_embed_dim=4, gin_channels=16, sr=6400,
                          text_enc_hidden_dim=text_dim))


@pytest.mark.gpu
def test_two_ranks_train_and_convert_on_card(cuda, tmp_path):
    """Two spawned ranks on the card (gloo when they share one card, NCCL
    with one card each): the sharded train step against the one-process
    step on the global batch (losses rtol 2e-4, each gradient leaf 1e-3 x
    its max |g|, the ranks' parameters bitwise equal), sharded conversion
    of 3 rows (one padding row) against one process's convert_batch
    (waveform <= 1e-3), 36 resblock_tc launches per rank per step and
    per decode."""
    from rvc_maker_tpu_torch.ops import build
    from rvc_maker_tpu_torch.parallel import distributed as dist_mod
    from rvc_maker_tpu_torch.pipelines import train as tr
    from torch_parallel_worker import join_ranks, start_ranks

    cfg = _narrow_rvc_config()
    b, t, seg = 4, 24, cfg.model.segment_size
    rs = np.random.RandomState(0)
    lengths = np.array([t, t, seg + 2, t - 5], np.int32)
    batch = dict(phone=rs.randn(b, t, 96).astype(np.float32), phone_lengths=lengths,
                 pitch=rs.randint(1, 256, (b, t)),
                 pitchf=(rs.rand(b, t) * 200 + 80).astype(np.float32),
                 spec=np.abs(rs.randn(b, t, 129)).astype(np.float32), spec_lengths=lengths,
                 wave=(rs.randn(b, t * 64, 1) * 0.1).astype(np.float32),
                 sid=rs.randint(0, 4, b))
    params_g = from_jax.synthesizer_from_jax(from_jax.random_synthesizer_tree(cfg.model, 4),
                                             cfg.model, train=True)
    params_d = from_jax.discriminator_from_jax(from_jax.random_discriminator_tree("v2", 16, 5))
    ccfg = _narrow_rvc_config(768).model
    tt = np.arange(16000) / 16000
    audio = np.stack([0.3 * np.sin(2 * np.pi * (150 + 20 * i) * tt)
                      for i in range(3)]).astype(np.float32)
    convert = dict(synth=_loud_synth(ccfg), cfg=ccfg,
                   hubert=from_jax.hubert_from_jax(from_jax.random_hubert_tree(1, n_layers=2)),
                   index=rs.randn(128, 768).astype(np.float32), max_device_batch=8,
                   settings=dict(f0_method="yin", index_rate=0.5, deterministic=True),
                   cases=[dict(name="odd", audio=audio, lengths=np.array([16000, 16000, 12000]))])
    torch.save(dict(device="cuda", convert=convert, step=dict(
        params_g=params_g, params_d=params_d, div=16,
        cases=[dict(name="drawn", cfg=cfg, batch=batch, noise=None)])), tmp_path / "inputs.pt")
    build.build_all(["resblock_tc"])        # once, before the ranks load it
    outs = join_ranks(start_ranks(str(tmp_path), 2), str(tmp_path))
    print(f"backend by rule: {dist_mod.backend_for('cuda', 2)} "
          f"({torch.cuda.device_count()} card(s))")

    state = tr.init_state(cfg, params_g, params_d, device=cuda, disc_width_div=16)
    torch.backends.cudnn.deterministic = True       # as the ranks run
    try:
        m = tr.make_train_step(cfg, 16)(state, tr.Batch(**batch).to(cuda), keep_grads=True)
    finally:
        torch.backends.cudnn.deterministic = False
    r0, r1 = (o["step"]["drawn"] for o in outs)
    for k in ("loss_g", "loss_d", "loss_mel", "loss_kl", "loss_fm", "loss_adv"):
        np.testing.assert_allclose(r0["metrics"][k], float(m[k]), rtol=2e-4, err_msg=k)
    assert_grads_close(r0["grads_g"], m["grads_g"], "G")
    assert_grads_close(r0["grads_d"], m["grads_d"], "D")
    np.testing.assert_array_equal(r0["params"], r1["params"])
    assert r0["resblock_tc_launches"] == r1["resblock_tc_launches"] == 36

    pipe = ConvertPipeline(convert["synth"], ccfg, convert["hubert"], version="v2",
                           index_vectors=convert["index"], device=cuda)
    wav, _ = pipe.convert_batch(audio, convert["cases"][0]["lengths"], 0,
                                ConvertSettings(**convert["settings"]))
    for out in outs:
        got, _, launches = out["convert"]["odd"]
        err = np.abs(got - n(wav)).max()
        assert got.shape == tuple(wav.shape) and err <= 1e-3, err
        assert launches == 36          # each rank decodes its rows in one microbatch


@pytest.mark.gpu
def test_rank_without_its_card_raises_on_card(cuda):
    """A rank whose card is named but absent raises; "cuda" shares the cards
    round-robin."""
    from rvc_maker_tpu_torch.parallel import distributed as dist_mod

    n_cards = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"cuda:{n_cards}"):
        dist_mod.rank_device(f"cuda:{n_cards}", rank=1)
    assert dist_mod.rank_device("cuda", rank=n_cards + 1) == torch.device("cuda", 1 % n_cards)


def _edit_song(path, seconds=0.5):
    from rvc_maker_tpu_torch.utils.audio import save_wav

    tt = np.arange(int(16000 * seconds)) / 16000
    save_wav(path, (0.4 * np.sin(2 * np.pi * 220 * tt)).astype(np.float32), 16000)
    return path


@pytest.mark.gpu
def test_audioldm2_vocoder_stage_on_resblock_tc(cuda, monkeypatch):
    """A SpeechT5 HiFi-GAN whose stages are at C = 256 / 128 (k = 3 / 7 /
    11, dilations 1 / 3 / 5) and 512: the kernel stages launch resblock_tc
    (3 per resblock), the C = 512 one none; the waveform against the same
    vocoder with every resblock on the plain chain, <= 1e-4 x max(1,
    |ref|max)."""
    from rvc_maker_tpu_torch.models import audioldm2 as am

    cfg = am.VocoderConfig(model_in_dim=64, upsample_initial_channel=1024, upsample_rates=(5, 2, 2),
                           upsample_kernel_sizes=(16, 4, 4))
    p = from_jax._random_vocoder(from_jax._Draws(0, cuda), cfg)
    spec = torch.randn(1, 200, 64, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    before = trb.resblock_tc_launches
    got = am.vocoder_apply(p, cfg, spec)
    torch.cuda.synchronize()
    assert trb.resblock_tc_launches - before == 2 * 3 * 3
    monkeypatch.setattr(am, "_on_kernel", lambda *a: False)
    ref = am.vocoder_apply(p, cfg, spec)
    err = (got - ref).abs().max().item()
    assert torch.isfinite(got).all() and err <= 1e-4 * max(1.0, ref.abs().max().item()), err


@pytest.mark.gpu
def test_edit_toy_stack_card_matches_cpu(cuda, tmp_path):
    """`edit` with the toy stack on the card and on the CPU, the same
    explicit noise: the written waveforms within 1e-3."""
    from rvc_maker_tpu_torch.edit import pipeline as ep
    from rvc_maker_tpu_torch.utils.audio import read_wav

    src = _edit_song(str(tmp_path / "in.wav"))
    cpu_stack = ep.ToyMelStack(device="cpu")
    w0 = cpu_stack.get_mel(read_wav(src)[0])[0]
    noise = torch.randn((8, *w0.shape), generator=torch.Generator().manual_seed(0))
    outs = [read_wav(ep.edit(src, str(tmp_path / f"{dev}.wav"), stack=ep.ToyMelStack(device=dev),
                             steps=8, t_start=50, sr=22050, device=dev, noise=noise))[0]
            for dev in ("cuda", "cpu")]
    assert outs[0].shape == outs[1].shape and outs[0].shape[1] == 2
    err = np.abs(outs[0] - outs[1]).max()
    assert err <= 1e-3, err


@pytest.mark.gpu
def test_edit_on_the_card_raises_without_one(cuda, tmp_path, monkeypatch):
    """With the card hidden, `edit(device="cuda")`, the stacks and `cli edit`
    raise instead of running on the CPU."""
    from rvc_maker_tpu_torch import cli
    from rvc_maker_tpu_torch.edit import pipeline as ep
    from rvc_maker_tpu_torch.edit import stack as st

    src = _edit_song(str(tmp_path / "in.wav"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: ep.edit(src, str(tmp_path / "out.wav"), device="cuda"),
                 lambda: ep.ToyMelStack(device="cuda"),
                 lambda: st.AudioLDM2Stack.init_tiny(0, device="cuda"),
                 lambda: cli.main(["edit", "--input-path", src, "--toy-stack"])):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()


def _spec_song(seconds, seed, sr=44100):
    rs = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    phase = 2 * np.pi * np.cumsum(220.0 * (1 + 0.03 * np.sin(2 * np.pi * 5 * t))) / sr
    x = sum(0.2 / h * np.sin(h * phase) for h in (1, 2, 3)) + 0.1 * rs.randn(len(t))
    return np.stack([x, 0.5 * x + 0.05 * rs.randn(len(t))]).astype(np.float32)


@pytest.mark.gpu
def test_spec_tools_card_matches_cpu(cuda):
    """pipelines/spec_tools.py on the card against the CPU: the STFT pair,
    min/max-magnitude ensembling, the two-band cmb_spectrogram_to_wave
    round trip and time_correction within 1e-5 x max(1, |ref|max), and
    every lag and window choice of the aligner equal."""
    from rvc_maker_tpu_torch.pipelines import spec_tools as st

    def close(got, ref, tol=1e-5):
        got, ref = np.asarray(got), np.asarray(ref)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        err = float(np.abs(got - ref).max())
        assert err <= tol * max(1.0, float(np.abs(ref).max())), err

    a, b = _spec_song(4.0, 0), 0.8 * _spec_song(4.0, 1)
    for dev_out, cpu_out in (
            (st.wave_to_spectrogram_no_mp(a, device="cuda"), st.wave_to_spectrogram_no_mp(a, device="cpu")),
            (st.spec_effects([a, b], "Max_Mag", device="cuda"), st.spec_effects([a, b], "Max_Mag", device="cpu")),
            (st.invert_stem(a, b, device="cuda"), st.invert_stem(a, b, device="cpu"))):
        close(dev_out, cpu_out)
    specs = [st.wave_to_spectrogram_no_mp(w, device="cpu") for w in (a, b)]
    for alg in (st.MIN_SPEC, st.MAX_SPEC):
        np.testing.assert_array_equal(st.ensembling(alg, specs, device="cuda"),
                                      st.ensembling(alg, specs, device="cpu"))
    mp = st.ModelParameters({
        "bins": 1025, "pre_filter_start": 1000, "pre_filter_stop": 1020,
        "band": {1: {"sr": 22050, "hl": 512, "n_fft": 1024, "crop_start": 0, "crop_stop": 400,
                     "lpf_start": 300, "lpf_stop": 380, "hpf_start": 0, "hpf_stop": 0},
                 2: {"sr": 44100, "hl": 1024, "n_fft": 2048, "crop_start": 100,
                     "crop_stop": 725, "hpf_start": 150, "hpf_stop": 100, "lpf_start": 0,
                     "lpf_stop": 0}}})

    def round_trip(dev):
        specs = {k: st.wave_to_spectrogram(st._resample(a, 44100, bd["sr"]), bd["hl"],
                                           bd["n_fft"], mp, k, device=dev)
                 for k, bd in mp.param["band"].items()}
        return st.cmb_spectrogram_to_wave(st.combine_spectrograms(specs, mp, device=dev), mp,
                                          device=dev)

    close(round_trip("cuda"), round_trip("cpu"))
    mix = a.T.astype(np.float64)
    take = -0.9 * np.roll(mix, 37, axis=0) + 0.01 * np.random.RandomState(2).randn(*mix.shape)
    win, step = 2205, 1102
    ref = np.stack([mix[s:s + win, 0] for s in range(0, 40000, step)])
    tgt = np.stack([take[s:s + win, 0] for s in range(0, 40000, step)])
    for ps in (180, 45):
        np.testing.assert_allclose(
            st._realign_window(ref, tgt, (0.0, [-1.0, 0.0, 1.0]), ps, device="cuda"),
            st._realign_window(ref, tgt, (0.0, [-1.0, 0.0, 1.0]), ps, device="cpu"),
            rtol=0, atol=1e-12)
    kw = dict(align_window=[0.05, 0.25], db_analysis=(0.0, [-1.0, 0.0, 1.0]), phase_shifts=180)
    close(st.time_correction(mix, take, 4, device="cuda", **kw),
          st.time_correction(mix, take, 4, device="cpu", **kw), 1e-6)


@pytest.mark.gpu
def test_kineto_figures_match_the_profiler_tree_on_card(cuda):
    """chip_smoke.py's `kineto_figures` against the profiler's event tree
    on the card: every kernel's device ms, the device ms the tree ties to
    each nested `convert.*` range, and every op's host self ms, equal to
    1e-6 ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    import chip_smoke

    def work():
        x = torch.randn(256, 256, device=cuda, requires_grad=True)
        with record_function("convert.outer"):
            y = (x @ x).relu()
            with record_function("convert.inner"):
                z = torch.nn.functional.conv1d(y[None], torch.randn(64, 256, 3, device=cuda))
            loss = z.sum() + y.softmax(-1).sum()
        loss.backward()
        for _ in range(50):
            x = x * 1.0001
        torch.cuda.synchronize()

    work()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            work()
    fig = chip_smoke.kineto_figures(prof.profiler.kineto_results.events(), "convert.")
    kernels, stages = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            kernels[e.name] = kernels.get(e.name, 0.0) + e.device_time_total / 1e3
        elif e.device_type == DeviceType.CPU and e.name.startswith("convert."):
            stages[e.name] = stages.get(e.name, 0.0) + e.device_time_total / 1e3
    host = {e.key: e.self_cpu_time_total / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CPU}
    assert kernels and set(stages) == {"convert.outer", "convert.inner"}
    for got, ref in ((fig["by_kernel"], kernels), (fig["stages"], stages),
                     (fig["host_self"], host)):
        assert set(got) == set(ref)
        assert max(abs(got[k] - v) for k, v in ref.items()) <= 1e-6
