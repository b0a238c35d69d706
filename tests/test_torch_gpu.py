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
from rvc_maker_tpu_torch.ops import resblock as trb
from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline, ConvertSettings
from torch_port_util import (assert_grads_close, n, packed_resblock, resblock_params,
                             resblock_x, t)


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
@pytest.mark.parametrize("dtype,tc", [(torch.float32, 3), (torch.bfloat16, 0)],
                         ids=["fp32", "bf16"])
def test_tc_route_counts_on_card(cuda, dtype, tc):
    """fp32 launches resblock_tc (both counts move); bf16 launches the
    FMA kernel (only resblock_launches moves)."""
    k, dils, C, T = 3, (1, 3, 5), 128, 300
    p = resblock_params(8, k, C, 3)
    x = t(resblock_x(T, C, b=1)).transpose(1, 2).contiguous().to(cuda)
    args = [a.to(cuda) for a in packed_resblock(p)]
    before, before_tc = trb.resblock_launches, trb.resblock_tc_launches
    trb.fused_resblock(x.to(dtype), *[a.to(dtype) for a in args], kernel_size=k,
                       dilations=dils)
    torch.cuda.synchronize()
    assert trb.resblock_launches - before == 3
    assert trb.resblock_tc_launches - before_tc == tc


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
    k, dils, C, T = 3, (1, 3, 5), 64, 600
    p = resblock_params(7, k, C, 3)
    x = t(resblock_x(T, C, b=1)).transpose(1, 2).contiguous().to(cuda)
    args = [a.to(cuda) for a in packed_resblock(p)]
    ref = trb._resblock(x, *args, kernel_size=k, dilations=dils)
    got = trb.fused_resblock(x.bfloat16(), *[a.bfloat16() for a in args],
                             kernel_size=k, dilations=dils).float()
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
        zs, ss = pipe.noise_shapes(1, pipe.frames(audio.shape[1]))
        gen = torch.Generator().manual_seed(5)
        z, s = torch.randn(zs, generator=gen), torch.randn(ss, generator=gen)
        before = trb.resblock_launches
        wav, _ = pipe.convert_batch(audio, lengths, 0, ConvertSettings(index_rate=0.5),
                                    z_noise=z, sine_noise=s)
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
                 sine_noise=rs.randn(b, 8 * 64, 1).astype(np.float32))
    params_g = from_jax.synthesizer_from_jax(from_jax.random_synthesizer_tree(cfg.model, 2),
                                             cfg.model, train=True)
    params_d = from_jax.discriminator_from_jax(from_jax.random_discriminator_tree("v2", 16, 3))
    out = {}
    for dev in ("cpu", "cuda"):
        state = tr.init_state(cfg, params_g, params_d, device=dev, disc_width_div=16)
        out[dev] = tr.make_train_step(cfg, 16)(
            state, batch.to(dev), keep_grads=True,
            noise={k: torch.as_tensor(v, device=dev) for k, v in noise.items()})
    for k in ("loss_g", "loss_d", "loss_mel", "loss_kl", "loss_fm", "loss_adv"):
        np.testing.assert_allclose(float(out["cuda"][k]), float(out["cpu"][k]), rtol=1e-4)
    for name in ("grads_g", "grads_d"):
        assert_grads_close(out["cuda"][name], out["cpu"][name], name)
