"""The port's resblock (ops/resblock.py) against the JAX package's.

On the CPU `fused_resblock` runs its plain version, `_resblock`, which
is held against JAX `_resblock` (models/synthesizer.py) and against the
Pallas kernel in interpret mode.  The CUDA kernel itself is checked on
the card by tests/test_torch_gpu.py and by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu.models.synthesizer import _resblock as jax_resblock
from rvc_maker_tpu.ops.pallas_resblock import fused_resblock as pallas_resblock
from rvc_maker_tpu.ops.pallas_resblock import pack_resblock_weights
from rvc_maker_tpu_torch.ops import resblock as trb
from torch_port_util import (BF16_ULPS, bf16_ulp, n, packed_resblock, resblock_params,
                             resblock_x, t, tree_np, torch_threads)  # noqa: F401

SHAPES = [
    (3, (1, 3, 5), 32, 700),
    (3, (1, 3, 5), 128, 512),
    (7, (1, 3, 5), 64, 1030),
    (11, (1, 3, 5), 32, 300),
    (3, (1, 2), 96, 450),
]


@pytest.mark.parametrize("k,dils,C,T", SHAPES)
def test_plain_matches_jax_resblock(k, dils, C, T):
    p = resblock_params(k * 1000 + C, k, C, len(dils))
    x = resblock_x(T, C)
    ref = jax_resblock(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
                       kernel_size=k, dilations=dils)
    got = trb.fused_resblock(t(x).transpose(1, 2).contiguous(), *packed_resblock(p),
                             kernel_size=k, dilations=dils)
    np.testing.assert_allclose(n(got.transpose(1, 2)), n(ref), atol=2e-5, rtol=2e-5)


def test_plain_matches_pallas_interpret():
    k, dils, C, T = 3, (1, 3, 5), 32, 300
    p = resblock_params(5, k, C, len(dils))
    x = resblock_x(T, C, b=1)
    w1, b1, w2, b2 = pack_resblock_weights(jax.tree_util.tree_map(jnp.asarray, p),
                                           kernel_size=k, dilations=dils)
    ref = pallas_resblock(jnp.asarray(x), w1, b1, w2, b2, kernel_size=k,
                          dilations=dils, interpret=True, t_tile=256)
    got = trb._resblock(t(x).transpose(1, 2), *packed_resblock(p), kernel_size=k,
                        dilations=dils)
    np.testing.assert_allclose(n(got.transpose(1, 2)), n(ref), atol=2e-5, rtol=2e-5)


def test_cpu_tensor_takes_plain_version_without_launch():
    k, dils, C, T = 7, (1, 3, 5), 32, 200
    p = resblock_params(6, k, C, len(dils))
    x = t(resblock_x(T, C)).transpose(1, 2).contiguous()
    before = trb.resblock_launches
    got = trb.fused_resblock(x, *packed_resblock(p), kernel_size=k, dilations=dils)
    assert trb.resblock_launches == before
    torch.testing.assert_close(got, trb._resblock(x, *packed_resblock(p), kernel_size=k,
                                                   dilations=dils), rtol=0, atol=0)


def test_other_devices_raise():
    x = torch.zeros(1, 32, 10, device="meta")
    w = torch.zeros(1, 3, 32, 32, device="meta")
    b = torch.zeros(1, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        trb.fused_resblock(x, w, b, w, b, kernel_size=3, dilations=(1,))


def test_pipeline_on_cuda_raises_without_card():
    from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline

    if torch.cuda.is_available():
        pytest.skip("a card is present: the pipeline would run on it")
    with pytest.raises(RuntimeError, match="cuda"):
        ConvertPipeline({}, None, {}, rmvpe_params={}, device="cuda")


def test_resblock_flops():
    assert trb.resblock_flops(1, 12000, 256, 11, 3) == 2 * 2 * 3 * 12000 * 11 * 256 * 256


@pytest.mark.parametrize("k,dils,C,T", [(3, (1, 3, 5), 16, 120), (7, (1, 3, 5), 32, 90),
                                        (11, (1, 3, 5), 16, 150)])
def test_autograd_matches_jax_grad(k, dils, C, T):
    """Gradients of the port's fused_resblock (its autograd backward) in
    x and every packed weight and bias, against jax.grad of the JAX
    `_resblock`: <= 1e-4 x max(1, |ref|max)."""
    p = resblock_params(k + C, k, C, len(dils))
    x = resblock_x(T, C)
    cot = np.random.RandomState(k).randn(*x.shape).astype(np.float32)

    def loss(params, xx):
        out = jax_resblock(params, xx, kernel_size=k, dilations=dils)
        return jnp.sum(out * jnp.asarray(cot))

    gp, gx = jax.grad(loss, argnums=(0, 1))(jax.tree_util.tree_map(jnp.asarray, p),
                                            jnp.asarray(x))
    ref = {"x": n(gx)}
    ref.update(zip(("w1", "b1", "w2", "b2"), (n(a) for a in packed_resblock(tree_np(gp)))))

    xt = t(x).transpose(1, 2).contiguous().requires_grad_(True)
    ws = [a.requires_grad_(True) for a in packed_resblock(p)]
    out = trb.fused_resblock(xt, *ws, kernel_size=k, dilations=dils)
    assert out.grad_fn is not None
    out.backward(t(cot).transpose(1, 2))
    got = {"x": n(xt.grad.transpose(1, 2))}
    got.update(zip(("w1", "b1", "w2", "b2"), (n(w.grad) for w in ws)))
    for name, r in ref.items():
        err = np.abs(got[name] - r).max()
        assert err <= 1e-4 * max(1.0, np.abs(r).max()), (name, err)


@pytest.mark.parametrize("device,dtype,C,route", [
    ("cpu", torch.float32, 128, "plain"),
    ("cpu", torch.bfloat16, 256, "plain"),
    *[("cuda", torch.float32, c, "tc") for c in trb.TC_WIDTHS],
    ("cuda", torch.bfloat16, 128, "tc_bf16"),
    ("cuda", torch.bfloat16, 256, "tc_bf16"),
])
def test_route(device, dtype, C, route):
    """cpu -> the plain steps; a CUDA fp32 tensor whose width the tensor-core
    kernel takes -> csrc/resblock_tc.cu; bf16 -> csrc/resblock_tc_bf16.cu."""
    assert trb._route(device, dtype, C) == route


def test_route_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        trb._route("meta", torch.float32, 128)


# ---------------------------------------------------------------------------
# A numpy model of csrc/resblock_tc.cu: one dilation step, tiled as the
# kernel tiles it (its time tile, its ring of weight stages), through its
# shared-memory images (swizzled, split into TF32 planes), ldmatrix's
# lane-to-row map, the m16n8k8 TF32 fragments and 3xTF32 in the kernel's
# order.  The kernel's index arithmetic is written from this model.
# ---------------------------------------------------------------------------

LANE = np.arange(32)
G, Q = LANE >> 2, LANE & 3           # groupID, thread in group

# csrc/resblock_tc.cu `Cfg`: KC, MT_MAX, WM, RING (weight stages), MINB
# (blocks an SM holds), T1F (the intermediate in fp32, split chunk by
# chunk), PRODUCER (a warp that fills the ring)
TC_CFG = {256: (16, 8, 2, 2, 1, True, False), 128: (32, 8, 2, 3, 1, False, True),
          64: (16, 8, 4, 3, 2, False, True), 32: (16, 16, 8, 3, 2, False, True),
          16: (16, 32, 8, 3, 1, False, True)}
SMEM_BLOCK = 232448          # bytes a block may use on sm_90
SMEM_TWO_BLOCKS = 115712     # each of two blocks on one SM: 228 KB less 1 KB a block
SMEM_SM = 233472             # an SM's shared memory, of which each block's 1 KB is reserved


def tf32_rna(v):
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    bits = np.asarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(v):
    hi = tf32_rna(v)
    return hi, tf32_rna(np.asarray(v, np.float32) - hi)


def tc_cfg(C, K):
    kc, mt_max, wm, ring, minb, t1f, producer = TC_CFG[C]
    wn = 8 // wm
    return dict(KC=kc, MT_MAX=mt_max, WM=wm, WN=wn, NTW=C // 8 // wn, MTW=mt_max // wm,
                RING=ring, MINB=minb, T1F=t1f, PRODUCER=producer, HC=(K - 1) // 2,
                NCH=C // kc, CPR=kc // 4, THREADS=256 + 32 * producer)


def tc_layout(C, K, mt1, dil):
    """csrc/resblock_tc.cu `layout`: rows of the x image, of the raw x chunk
    and of conv2's image, the byte offsets of each region, the total."""
    g = tc_cfg(C, K)
    kc, ring = g["KC"], g["RING"]
    xr = 16 * mt1 + (K - 1) * dil
    xrp = (xr + 6) & ~3
    r2 = 16 * mt1 + K - 1
    image, raw = 2 * xr * kc * 4, kc * xrp * 4
    if g["T1F"]:                     # [t1 fp32][x image + raw | conv2 image][ring]
        t1, img = 0, 16 * mt1 * C * 4
        ring_at = img + ((max(image + raw, 2 * r2 * kc * 4) + 15) & ~15)
        raw_at = img + image
    else:                            # [x image + raw | t1 hi, lo][ring]
        t1_bytes = 2 * 16 * mt1 * C * 4
        ring_at = (max(image + raw, t1_bytes) + 15) & ~15
        img, raw_at, t1 = 0, image, ring_at - t1_bytes
    bars = ring_at + ring * 2 * C * kc * 4
    return dict(xr=xr, xrp=xrp, r2=r2, image=img, raw=raw_at, t1=t1, ring=ring_at,
                bars=bars, total=bars + 2 * ring * 8)


def swz(r, c, cpr):
    """`swz` (both kernels): where chunk c of row r lies in an image of cpr
    16-byte chunks a row, so that any 8 consecutive rows of one chunk fall
    on 8 distinct bank groups."""
    return c ^ ((r & 7) if cpr >= 8 else ((r // (8 // cpr)) & (cpr - 1)))


def ldsm_x4(mem, chunk):
    """ldmatrix.x4.b16 on 32-bit words: chunk (..., 32) is each lane's row
    address in 16-byte chunks of the word image `mem` (lanes 8i..8i+7 give
    matrix i's 8 rows).  Lane (g, q) receives word q of row g of matrix i
    in register i: (..., 4, 32).  The 8 rows of each matrix fall on 8
    distinct bank groups (no conflict)."""
    rows = chunk.reshape(*chunk.shape[:-1], 4, 8)
    assert (np.sort(rows % 8, axis=-1) == np.arange(8)).all()
    return mem[rows[..., G] * 4 + Q]


def a_frags_to_tile(r):
    """m16n8k8 TF32 A: a0..a3 = A[g][q], A[g+8][q], A[g][q+4], A[g+8][q+4]."""
    a = np.empty(r.shape[:-2] + (16, 8), np.float32)
    a[..., G, Q], a[..., G + 8, Q] = r[..., 0, :], r[..., 1, :]
    a[..., G, Q + 4], a[..., G + 8, Q + 4] = r[..., 2, :], r[..., 3, :]
    return a


def b_frags_to_tiles(r):
    """Two n-tiles' B from one ldmatrix.x4: b0 = B[q][g], b1 = B[q+4][g] of
    n-tile 0 in registers 0, 1, of n-tile 1 in registers 2, 3."""
    b = np.empty(r.shape[:-2] + (2, 8, 8), np.float32)
    for p in range(2):
        b[..., p, Q, G], b[..., p, Q + 4, G] = r[..., 2 * p, :], r[..., 2 * p + 1, :]
    return b


def mma_tf32(acc, a, b):
    """mma.sync.m16n8k8 f32.tf32.tf32.f32 on every (m-tile, n-tile): the
    products of TF32 values are exact; the fp32 accumulator rounds once
    per MMA."""
    d = np.einsum("mik,nkj->mnij", a.astype(np.float64), b.astype(np.float64))
    return (acc + d).astype(np.float32)


def warp_tiles(warp, g, mt_total):
    """A warp's m-tiles (every WM-th, from wm) and n-tiles (NTW in a row)."""
    wn, wm = warp % g["WN"], warp // g["WN"]
    mts = np.arange(wm, mt_total, g["WM"])
    nts = wn * g["NTW"] + np.arange(g["NTW"])
    return mts, nts


def stage_mma(acc, mem, plane, shift, cbase, cpr_a, stage, g, C):
    """`stage_mma`: acc (MT, C/8, 16, 8) += one stage, A rows m*16 + .. +
    shift of an image of cpr_a chunks a row (lo plane `plane` words on),
    chunks from cbase; the stage's weights (hi plane, then lo)."""
    mt = acc.shape[0]
    n = (2 * np.arange(C // 16)[:, None] + (LANE >> 4)) * 8 + (LANE & 7)
    lrow = (LANE & 7) + 8 * ((LANE >> 3) & 1)
    row = np.arange(mt)[:, None] * 16 + lrow + shift
    for ks in range(g["KC"] // 8):
        wch = n * g["CPR"] + swz(n, 2 * ks + ((LANE >> 3) & 1), g["CPR"])
        bh, bl = (b_frags_to_tiles(ldsm_x4(stage[h * C * g["KC"]:], wch)).reshape(C // 8, 8, 8)
                  for h in (0, 1))
        ach = row * cpr_a + swz(row, cbase + 2 * ks + (LANE >> 4), cpr_a)
        ah, al = (a_frags_to_tile(ldsm_x4(mem[h * plane:], ach)) for h in (0, 1))
        for a, b in ((al, bh), (ah, bl), (ah, bh)):       # small terms first
            acc = mma_tf32(acc, a, b)
    return acc


def tc_step_model(x, pack, b1, b2, K, dil, tt):
    """One step of one batch row, x (C, T) -> x + conv2(lrelu(conv1(lrelu(x)))),
    in time tiles of tt rows, through shared-memory images laid out as the
    kernel lays them out.  pack: this step's `_tc_pack` slab (flat), which
    the ring's slots hold stage by stage.  Words the kernel never writes
    hold NaN, so a fragment that reads one into a kept output poisons it."""
    C, T = x.shape
    g = tc_cfg(C, K)
    kc, cpr, hc, nch = g["KC"], g["CPR"], g["HC"], g["NCH"]
    lrelu = lambda v: np.where(v >= 0, v, np.float32(0.1) * v).astype(np.float32)
    mt1_launch = -(-(tt + 2 * hc) // 16)
    assert mt1_launch <= g["MT_MAX"]
    L = tc_layout(C, K, mt1_launch, dil)
    xrp = L["xrp"]
    stages = pack.reshape(2 * nch * K, 2 * C * kc)
    aligned = T % 4 == 0
    out = np.full_like(x, np.nan)
    for t0 in range(0, T, tt):
        rows = min(tt, T - t0)
        mt1 = min(mt1_launch, -(-(rows + 2 * hc) // 16))
        mt2 = -(-rows // 16)
        for mt in (mt1, mt2):            # the 8 warps cover each tile once
            tiles = [(m, n) for w in range(8) for m, nts in [warp_tiles(w, g, mt)]
                     for m in m for n in nts]
            assert sorted(tiles) == [(m, n) for m in range(mt) for n in range(C // 8)]
        xstart = t0 - hc - hc * dil
        sh = xstart % 4 if aligned else 0
        xa, xr = xstart - sh, 16 * mt1 + (K - 1) * dil
        # ---- conv1, chunk outer, tap inner
        acc = np.zeros((mt1, C // 8, 16, 8), np.float32)
        for ci in range(nch):
            raw = np.full(kc * xrp, np.nan, np.float32)     # the producer's copies
            xc = x[ci * kc:(ci + 1) * kc]
            if aligned:                  # 16-byte chunks, all in [0, T) or zeros
                u = np.arange((xr + sh + 3) // 4)
                ok = (xa + 4 * u >= 0) & (xa + 4 * u + 4 <= T)
                for e in range(4):
                    raw[(np.arange(kc)[:, None] * xrp + 4 * u + e)] = np.where(
                        ok, xc[:, np.clip(xa + 4 * u + e, 0, T - 1)], 0)
            else:                        # word by word
                r = np.arange(xr)
                ok = (xa + r >= 0) & (xa + r < T)
                raw[np.arange(kc)[:, None] * xrp + r] = np.where(ok, xc[:, np.clip(xa + r, 0, T - 1)], 0)
            img = np.full(2 * L["xr"] * kc, np.nan, np.float32)   # [row][KC] x hi, lo
            r = np.arange(xr)
            for cq in range(cpr):
                word = (r * cpr + swz(r, cq, cpr)) * 4
                for e in range(4):
                    hi, lo = split_tf32(lrelu(raw[(cq * 4 + e) * xrp + r + sh]))
                    img[word + e], img[xr * kc + word + e] = hi, lo
            for j in range(K):
                acc = stage_mma(acc, img, xr * kc, j * dil, 0, cpr, stages[ci * K + j], g, C)
        # ---- + b1, lrelu, zero outside [0, T) -> the intermediate [row][C]
        m = np.arange(16 * mt1)
        v = acc.transpose(0, 2, 1, 3).reshape(16 * mt1, C) + b1
        tm = t0 - hc + m
        v = np.where(((tm >= 0) & (tm < T))[:, None], lrelu(v), 0).astype(np.float32)
        cols = np.arange(C)
        word = (m[:, None] * (C // 4) + swz(m[:, None], cols // 4, C // 4)) * 4 + cols % 4
        plane = 16 * mt1_launch * C
        if g["T1F"]:
            t1 = np.full(plane, np.nan, np.float32)
            t1[word] = v
        else:                            # hi, lo; then the ring's words
            t1 = np.full(2 * plane + 16 * C, np.nan, np.float32)
            t1[word], t1[plane + word] = split_tf32(v)
        # ---- conv2 over rows [t0, t0 + 16 * mt2)
        acc = np.zeros((mt2, C // 8, 16, 8), np.float32)
        for ci in range(nch):
            for j in range(K):
                stage = stages[(nch + ci) * K + j]
                if g["T1F"]:
                    if j == 0:           # chunk ci of t1 split into its image
                        img2 = np.full(2 * L["r2"] * kc, np.nan, np.float32)
                        r = np.arange(16 * mt2 + 2 * hc)
                        for cq in range(cpr):
                            dst = (r * cpr + swz(r, cq, cpr)) * 4
                            src = (r * (C // 4) + swz(r, ci * cpr + cq, C // 4)) * 4
                            for e in range(4):
                                vv = np.where(r < 16 * mt1, t1[np.minimum(src + e, plane - 1)], 0)
                                img2[dst + e], img2[L["r2"] * kc + dst + e] = split_tf32(vv)
                    acc = stage_mma(acc, img2, L["r2"] * kc, j, 0, cpr, stage, g, C)
                else:
                    acc = stage_mma(acc, t1, plane, j, ci * cpr, C // 4, stage, g, C)
        d = acc.transpose(0, 2, 1, 3).reshape(16 * mt2, C)[:rows].T
        out[:, t0:t0 + rows] = x[:, t0:t0 + rows] + (d + b2[:, None])
    return out


def _tc_case(C, k, seed):
    p = resblock_params(seed, k, C, 1)
    w1, b1, w2, b2 = packed_resblock(p)
    pack = trb._tc_pack(w1, w2)[0].numpy().reshape(-1)
    return w1, b1, w2, b2, pack


@pytest.mark.parametrize("C", trb.SUPPORTED_C)
@pytest.mark.parametrize("k", trb.SUPPORTED_K)
def test_tc_fragment_model_matches_branch(C, k):
    """The model of the tensor-core kernel's step, at the longest tile and
    T across two tiles (T odd: x staged word by word; at k = 7 a multiple
    of 4: in 16-byte chunks), against x + _branch: <= 1e-5 x
    max(1, |ref|max)."""
    dil = 3
    tt = 16 * trb.TC_TILES[C][1] - (k - 1)
    T = tt + (36 if k == 7 else 37)
    w1, b1, w2, b2, pack = _tc_case(C, k, C * k)
    x = resblock_x(T, C, b=1)[0].T.copy()                   # (C, T)
    got = tc_step_model(x, pack, n(b1[0]), n(b2[0]), k, dil, tt)
    xt = t(x)[None]
    ref = n(xt + trb._branch(xt, w1[0], b1[0], w2[0], b2[0], k, dil))[0]
    err = np.abs(got - ref).max()
    assert np.isfinite(got).all() and err <= 1e-5 * max(1.0, np.abs(ref).max()), err


def test_tc_model_tiles_agree_bitwise():
    """Every output sums the same products in the same order whatever the
    time tile: the model at two tiles gives the same bits (so does the
    kernel on the card, tests/test_torch_gpu.py)."""
    C, k, dil, T = 64, 7, 2, 300
    w1, b1, w2, b2, pack = _tc_case(C, k, 3)
    x = resblock_x(T, C, b=1)[0].T.copy()
    outs = [tc_step_model(x, pack, n(b1[0]), n(b2[0]), k, dil, tt) for tt in (118, 40)]
    assert np.array_equal(outs[0], outs[1])


def test_tc_geometry_fits_shared_memory():
    """Every (C, k, dil) the kernel takes, at every tile up to its longest,
    fits the 227 KB a block may use (two blocks an SM where the kernel
    keeps two: 113 KB each), its regions in order; conv1's rows cover
    conv2's halo; every warp holds 2 x 2 tiles or more; a chunk's raw x
    is copied again only after its k taps have begun."""
    for C in trb.SUPPORTED_C:
        for k in trb.SUPPORTED_K:
            g = tc_cfg(C, k)
            kc, mt_max, wm, per_sm = trb.TC_TILES[C]
            assert (kc, mt_max, wm, per_sm) == (g["KC"], g["MT_MAX"], g["WM"], g["MINB"])
            assert g["NTW"] >= 2 and g["MTW"] >= 2 and g["NCH"] * kc == C
            tt_max = 16 * mt_max - (k - 1)
            assert -(-(tt_max + k - 1) // 16) == mt_max
            for dil in range(1, trb.MAX_DILATION + 1):
                for tt in (17, tt_max // 2, tt_max):
                    mt1 = -(-(tt + k - 1) // 16)
                    L = tc_layout(C, k, mt1, dil)
                    limit = SMEM_TWO_BLOCKS if per_sm == 2 else SMEM_BLOCK
                    assert 2 <= g["RING"] <= k and L["total"] <= limit, (C, k, dil, tt)
                    assert L["raw"] + kc * L["xrp"] * 4 <= L["ring"]
                    assert L["image"] + 2 * L["xr"] * kc * 4 <= L["raw"]
                    assert L["xrp"] % 4 == 0 and L["xrp"] >= L["xr"] + 3
                    assert 16 * mt1 >= tt + k - 1


def test_three_tf32_passes_hold_fp32_accuracy():
    """One k = 11, C = 256 conv over 64 rows, summed as the kernel sums it
    (chunks of KC = 16 channels outer, taps inner, 8 channels per MMA, the
    fp32 accumulator rounded after each of the 352 x 3 MMAs), relative to
    the fp64 result's max.  3xTF32 stays within 3x of fp32 FMA summed in the
    same order (about 1e-6 each) and within 1e-5; 1xTF32 does not stay
    within 1e-4, the kernel check's tolerance.  That is why the kernel
    takes three passes."""
    K, C, M = 11, 256, 64
    kc = trb.TC_TILES[C][0]
    rs = np.random.RandomState(0)
    a = rs.randn(M + K - 1, C).astype(np.float32) * np.float32(0.3)
    a = np.where(a >= 0, a, np.float32(0.1) * a).astype(np.float32)
    w = (rs.randn(K, C, C) * (0.5 / np.sqrt(K * C))).astype(np.float32)
    ref = sum(a[j:j + M].astype(np.float64) @ w[j].astype(np.float64) for j in range(K))
    errs = {}
    for method in ("fp32", "1xtf32", "3xtf32"):
        acc = np.zeros((M, C), np.float32)
        for ci in range(C // kc):
            for j in range(K):
                for ks in range(kc // 8):
                    c0 = ci * kc + 8 * ks
                    aa, bb = a[j:j + M, c0:c0 + 8], w[j, c0:c0 + 8]
                    (ah, al), (bh, bl) = split_tf32(aa), split_tf32(bb)
                    terms = {"fp32": [(aa, bb)], "1xtf32": [(ah, bh)],
                             "3xtf32": [(al, bh), (ah, bl), (ah, bh)]}[method]
                    for u, v in terms:
                        acc = (acc + u.astype(np.float64) @ v.astype(np.float64)).astype(np.float32)
        errs[method] = np.abs(acc - ref).max() / np.abs(ref).max()
    assert errs["3xtf32"] <= min(1e-5, 3 * errs["fp32"]), errs
    assert errs["1xtf32"] > 1e-4, errs


@pytest.mark.parametrize("C", [256, 32])
def test_tc_pack_splits_the_weights_once_in_the_kernel_layout(C):
    """`_tc_pack`'s words, in memory order, against a numpy split (hi =
    rna(w), lo = rna(w - hi), bit for bit, ties included) laid out as the
    kernel's stages: [step][conv][chunk][tap][hi, lo][C_out][KC], the
    16-byte chunks of each C_out row at c ^ key(row)."""
    k, D = 3, 2
    kc = trb.TC_TILES[C][0]
    rs = np.random.RandomState(C)
    w = (rs.randn(2, D, k, C, C) * 0.1).astype(np.float32)
    w.reshape(-1)[:64] = np.float32(1 + 2 ** -11)           # ties round away from zero
    w.reshape(-1)[64:128] = -np.float32(1 + 3 * 2 ** -11)
    got = trb._tc_pack(t(w[0]), t(w[1]))
    assert got.is_contiguous() and got.dtype == torch.float32
    hi, lo = split_tf32(w)                                  # (conv, D, k, C_in, C_out)
    assert (hi.reshape(-1)[:64] == np.float32(1 + 2 ** -10)).all()
    want = np.full((D, 2, C // kc, k, 2, C, kc), np.nan, np.float32)
    n = np.arange(C)[:, None]
    for ci in range(C // kc):
        for pc in range(kc // 4):
            src = ci * kc + 4 * swz(n, pc, kc // 4) + np.arange(4)      # (C, 4) input channels
            for h, plane in enumerate((hi, lo)):
                want[:, :, ci, :, h, :, 4 * pc:4 * pc + 4] = (
                    plane[:, :, :, src, n].transpose(1, 0, 2, 3, 4))
    assert np.array_equal(got.numpy().reshape(-1).view(np.uint32),
                          want.reshape(-1).view(np.uint32))


def _main_path_stages():
    """(B, C, T) of the v2-48k resblock stages: conversion on 2 x 10 s and
    training at B = 8 on the config's segment, as chip_smoke.py takes them."""
    from rvc_maker_tpu_torch.config import preset
    from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline

    cfg = preset("v2", 48000).model
    out = []
    for b, t0 in ((2, ConvertPipeline.frames(16000 * 10)), (8, cfg.segment_size)):
        tt, c = t0, cfg.upsample_initial_channel
        for u in cfg.upsample_rates:
            tt, c = tt * u, c // 2
            out.append((b, c, tt, tuple(cfg.resblock_kernel_sizes)))
    return out


def test_tc_time_tile_fills_the_card_and_covers_rows():
    """At every main-path stage and k the tiles cover [0, T) exactly, each
    within the kernel's m-tiles and at least 17 rows.  At the training
    stage C = 256, T = 432, B = 8 the grid is one wave: 128 blocks of 27
    rows (136, two waves on 4 SMs, took 0.918 / 1.712 / 2.508 ms at k = 3
    / 7 / 11 on the card against 0.604 / 1.070 / 1.467 for 128:
    chip_smoke.py phase 6, NVIDIA H100 80GB HBM3).  Where
    the longest tile needs more than a wave at C >= 128, the tiles fill
    the last wave to 90 % or more (C = 256 in conversion: 264 blocks, 2
    waves)."""
    stages = _main_path_stages()
    assert (8, 256, 432, (3, 7, 11)) in stages and (2, 256, 11976, (3, 7, 11)) in stages
    for b, c, tlen, ks in stages:
        per_sm = trb.TC_TILES[c][3]
        for k in ks:
            tt = trb.tc_time_tile("tc", b, tlen, c, k)
            tiles = -(-tlen // tt)
            assert (tiles - 1) * tt < tlen <= tiles * tt
            assert min(17, tlen) <= tt and -(-(tt + k - 1) // 16) <= trb.TC_TILES[c][1]
            last = b * tiles % trb.CARD_SMS            # blocks in the last wave
            if per_sm == 1:
                assert last == 0 or last >= 0.9 * trb.CARD_SMS or b * tiles < trb.CARD_SMS, \
                    (b, c, tlen, k, b * tiles)
    assert 8 * -(-432 // trb.tc_time_tile("tc", 8, 432, 256, 11)) == 128
    assert 2 * -(-11976 // trb.tc_time_tile("tc", 2, 11976, 256, 11)) == 264


# ---------------------------------------------------------------------------
# A numpy model of csrc/resblock_tc_bf16.cu: one dilation step in bf16,
# tiled as the kernel tiles it (its time tile, its ring of weight stages),
# through its shared-memory images (time-major, swizzled), the staging
# pass's transposing ldmatrix, ldmatrix's lane maps (x4 for A, x4.trans
# for B), the m16n8k16 bf16 fragments and the fp32 output tile, with a
# bank check on every shared access.  The kernel's index arithmetic is
# written from this model.
# ---------------------------------------------------------------------------

# csrc/resblock_tc_bf16.cu `Cfg`: KC, MT_MAX, WM, RING, MINB
TC_BF16_CFG = {256: (64, 8, 2, 3, 1), 128: (64, 8, 2, 3, 2), 64: (32, 16, 4, 3, 2),
               32: (32, 32, 8, 3, 2), 16: (16, 32, 8, 3, 2)}
TILE_PAD = 12                # kTilePad: the fp32 tile's row is 16 * MT1 + 12 words


def bf16(v):
    """Round fp32 to bf16 (to nearest, ties to even), kept as fp32."""
    bits = np.asarray(v, np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return bits.view(np.float32)


def tc_bf16_cfg(C, K):
    kc, mt_max, wm, ring, minb = TC_BF16_CFG[C]
    wn = 8 // wm
    return dict(KC=kc, MT_MAX=mt_max, WM=wm, WN=wn, NTW=C // 8 // wn, MTW=mt_max // wm,
                RING=ring, MINB=minb, HC=(K - 1) // 2, NCH=C // kc,
                CPR_X=kc // 8, CPR_T=C // 8, THREADS=256)


def tc_bf16_layout(C, K, mt1, dil):
    """csrc/resblock_tc_bf16.cu `layout`: the x image's rows, the raw chunk's
    16-byte chunks per channel row, the byte offsets of each region (the
    fp32 output tile at 0 over the others), the total."""
    g = tc_bf16_cfg(C, K)
    kc, ring = g["KC"], g["RING"]
    xrc = (16 * mt1 + (K - 1) * dil + 14) // 8
    image, raw = 8 * xrc * kc * 2, kc * (xrc | 1) * 16
    t1 = 16 * mt1 * C * 2
    ring_at = (max(image + raw, t1) + 15) & ~15
    ring_end = ring_at + ring * kc * C * 2
    tile = C * (16 * mt1 + TILE_PAD) * 4
    return dict(ir=8 * xrc, xrpc=xrc | 1, image=0, raw=image, t1=ring_at - t1, ring=ring_at,
                ring_end=ring_end, tile=tile, total=max(ring_end, tile))


def banks_distinct(words):
    """32-bit shared accesses of a warp, one per lane along the last axis,
    on 32 distinct banks."""
    assert (np.sort(np.asarray(words) % 32, axis=-1) == np.arange(32)).all(), words


def ldsm_b16(mem, chunk, trans=False):
    """ldmatrix.x4[.trans].b16: chunk (..., 32) is each lane's row address
    in 16-byte chunks of the b16 image `mem` (lanes 8i..8i+7 give matrix
    i's 8 rows).  Returns (low, high) halves of the registers, each (...,
    4, 32): lane (g, q) receives M_i[g][2q], M_i[g][2q + 1] of matrix i in
    register i, or, transposed, M_i[2q][g], M_i[2q + 1][g].  The 8 rows of
    each matrix fall on 8 distinct bank groups (no conflict)."""
    rows = chunk.reshape(*chunk.shape[:-1], 4, 8)
    assert (np.sort(rows % 8, axis=-1) == np.arange(8)).all()
    m = mem[rows[..., None] * 8 + np.arange(8)]           # (..., 4, row, column)
    if trans:
        return m[..., 2 * Q, G], m[..., 2 * Q + 1, G]
    return m[..., G, 2 * Q], m[..., G, 2 * Q + 1]


def a16_frags_to_tile(lo, hi):
    """m16n8k16 bf16 A from one ldmatrix.x4: a0..a3 = A[g][2q..2q+1],
    A[g+8][2q..], A[g][2q+8..], A[g+8][2q+8..] (the lower column in the
    low half)."""
    a = np.full(lo.shape[:-2] + (16, 16), np.nan, np.float32)
    for i, (r0, c0) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        a[..., r0 + G, c0 + 2 * Q], a[..., r0 + G, c0 + 2 * Q + 1] = lo[..., i, :], hi[..., i, :]
    return a


def b16_frags_to_tiles(lo, hi):
    """Two n-tiles' m16n8k16 B from one ldmatrix.x4.trans: b0 =
    B[2q..2q+1][g], b1 = B[2q+8..2q+9][g] of n-tile 0 in registers 0, 1,
    of n-tile 1 in 2, 3."""
    b = np.full(lo.shape[:-2] + (2, 16, 8), np.nan, np.float32)
    for p in range(2):
        for h in range(2):
            b[..., p, 8 * h + 2 * Q, G] = lo[..., 2 * p + h, :]
            b[..., p, 8 * h + 2 * Q + 1, G] = hi[..., 2 * p + h, :]
    return b


def mma_bf16(acc, a, b):
    """mma.sync.m16n8k16 f32.bf16.bf16.f32 on every (m-tile, n-tile): the
    products of bf16 values are exact; the fp32 accumulator rounds once
    per MMA."""
    d = np.einsum("mik,nkj->mnij", a.astype(np.float64), b.astype(np.float64))
    return (acc + d).astype(np.float32)


def bf16_stage_mma(acc, mem, shift, cbase, cpr_a, slot, g, C):
    """`stage_mma`: acc (MT, C/8, 16, 8) += one stage, A rows m*16 + .. +
    shift of a b16 image of cpr_a chunks a row, its chunks from cbase; B
    from the slot ([KC][C], rows swizzled), pair p of n-tiles from one
    x4.trans."""
    mt = acc.shape[0]
    lrow = (LANE & 7) + 8 * ((LANE >> 3) & 1)
    row = np.arange(mt)[:, None] * 16 + lrow + shift
    for ks in range(g["KC"] // 16):
        r = ks * 16 + lrow
        c = 2 * np.arange(C // 16)[:, None] + (LANE >> 4)
        b = b16_frags_to_tiles(*ldsm_b16(slot, r * g["CPR_T"] + swz(r, c, g["CPR_T"]), True))
        ach = row * cpr_a + swz(row, cbase + 2 * ks + (LANE >> 4), cpr_a)
        acc = mma_bf16(acc, a16_frags_to_tile(*ldsm_b16(mem, ach)), b.reshape(C // 8, 16, 8))
    return acc


def bf16_ring_slot(w, ci, j, g, C):
    """Stage (chunk ci, tap j) of one conv's weights w (k, C_in, C_out) as
    its ring slot holds it: KC rows of C_out, the 16-byte chunk i of the
    copy (row i // CPR_T) at its swizzled place."""
    kc, cpr = g["KC"], g["CPR_T"]
    slot = np.full(kc * C, np.nan, np.float32)
    i = np.arange(kc * cpr)
    r = i // cpr
    slot[(r * cpr + swz(r, i % cpr, cpr))[:, None] * 8 + np.arange(8)] = (
        w[j, ci * kc:(ci + 1) * kc].reshape(-1, 8))
    return slot


def lanes_distinct(items, width, key=None):
    """A loop over items, thread t taking items t, t + 256, ..: each group
    of `width` consecutive items (a warp's 32 lanes for 32-bit accesses, a
    quarter warp's 8 for 16-byte ones) falls on distinct banks or bank
    groups, `items` holding each one's bank (group); with `key`, among the
    items of one key (one channel row) only."""
    key = np.zeros(len(items), int) if key is None else key
    for s in range(0, len(items), width):
        for k in np.unique(key[s:s + width]):
            b = items[s:s + width][key[s:s + width] == k]
            assert len(np.unique(b)) == len(b), (s, items[s:s + width])


def tc_bf16_step_model(x, w1, b1, w2, b2, K, dil, tt):
    """One bf16 step of one batch row, x (C, T) of bf16 values ->
    bf16(x + conv2(bf16(lrelu(conv1(bf16(lrelu(x))) + b1))) + b2), in time
    tiles of tt rows, through shared-memory images laid out as the kernel
    lays them out; w (k, C_in, C_out), b (C,).  Words the kernel never
    writes hold NaN, so a fragment that reads one into a kept output
    poisons it.  T a multiple of 8 takes the 16-byte staging and stores,
    T = 4 mod 8 the same in 8-byte halves, another T the 2-byte ones."""
    C, T = x.shape
    g = tc_bf16_cfg(C, K)
    kc, hc, nch, cpr_x, cpr_t = g["KC"], g["HC"], g["NCH"], g["CPR_X"], g["CPR_T"]
    lrelu = lambda v: np.where(v >= 0, v, np.float32(0.1) * v).astype(np.float32)
    mt1_launch = -(-(tt + 2 * hc) // 16)
    assert mt1_launch <= g["MT_MAX"]
    L = tc_bf16_layout(C, K, mt1_launch, dil)
    xrpc, st = L["xrpc"], 16 * mt1_launch + TILE_PAD
    vec = 8 if T % 8 == 0 else 4 if T % 4 == 0 else 1     # bf16 a global access
    aligned = vec > 1
    slots = [bf16_ring_slot(w, ci, j, g, C) for w in (w1, w2) for ci in range(nch)
             for j in range(K)]
    out = np.full_like(x, np.nan)
    for t0 in range(0, T, tt):
        rows = min(tt, T - t0)
        mt1 = min(mt1_launch, -(-(rows + 2 * hc) // 16))
        mt2 = -(-rows // 16)
        for mt in (mt1, mt2):            # the 8 warps cover each tile once
            tiles = [(m, n) for w in range(8) for m, nts in [warp_tiles(w, g, mt)]
                     for m in m for n in nts]
            assert sorted(tiles) == [(m, n) for m in range(mt) for n in range(C // 8)]
        xstart = t0 - hc - hc * dil
        sh = xstart % 8 if aligned else 0
        xa, xr = xstart - sh, 16 * mt1 + (K - 1) * dil
        xrc = (xr + sh + 7) // 8
        # ---- conv1, chunk outer, tap inner
        acc = np.zeros((mt1, C // 8, 16, 8), np.float32)
        for ci in range(nch):
            xc = x[ci * kc:(ci + 1) * kc]
            img = np.full(L["ir"] * kc, np.nan, np.float32)       # [row][KC] b16
            if aligned:
                # the raw chunk: cp.async of 8 times a channel (two of 4
                # where vec = 4), each piece whole in [0, T) or zeros
                raw = np.full(kc * xrpc * 8, np.nan, np.float32)
                u = np.arange(xrc)
                tm = xa + 8 * u[:, None] + np.arange(8)
                piece = tm - tm % vec
                ok = (piece >= 0) & (piece + vec <= T)
                assert ((np.arange(kc)[:, None, None] * T + piece[None]) % vec == 0).all()
                raw[(np.arange(kc)[:, None, None] * xrpc + u[:, None]) * 8 + np.arange(8)] = (
                    np.where(ok, xc[:, np.clip(tm, 0, T - 1)], 0))
                # transposed 8 x 8 at a time by ldmatrix.x4.trans, matrix b
                # = channels 8 (b % CPR_X) .. x raw chunk b // CPR_X
                nblk = xrc * cpr_x
                b0 = np.arange(0, nblk, 4)[:, None]
                bl = np.minimum(b0 + (LANE >> 3), nblk - 1)
                lo, hi = ldsm_b16(raw, ((bl % cpr_x) * 8 + (LANE & 7)) * xrpc + bl // cpr_x, True)
                b = b0 + np.arange(4)                                # (groups, 4)
                row = 8 * (b // cpr_x)[..., None] + G
                word = (row * cpr_x + swz(row, (b % cpr_x)[..., None], cpr_x)) * 4 + Q
                banks_distinct(word)
                keep = b < nblk
                img[2 * word[keep]], img[2 * word[keep] + 1] = (bf16(lrelu(lo[keep])),
                                                               bf16(lrelu(hi[keep])))
            else:
                # word p (channels 2p, 2p + 1) of row r, thread i = r KC/2 + p
                r, p = np.divmod(np.arange(kc // 2 * xr), kc // 2)
                word = (r * cpr_x + swz(r, p >> 2, cpr_x)) * 4 + (p & 3)
                lanes_distinct(word % 32, 32)
                tm = xstart + r
                ok = (tm >= 0) & (tm < T)
                tm = np.clip(tm, 0, T - 1)
                img[2 * word] = np.where(ok, bf16(lrelu(xc[2 * p, tm])), 0)
                img[2 * word + 1] = np.where(ok, bf16(lrelu(xc[2 * p + 1, tm])), 0)
            for j in range(K):
                acc = bf16_stage_mma(acc, img, j * dil + sh, 0, cpr_x, slots[ci * K + j], g, C)
        # ---- bf16(lrelu(+ b1)), 0 outside [0, T) -> the intermediate [row][C]
        m = np.arange(mt1)[:, None, None, None] * 16 + G + 8 * np.arange(2)[:, None]  # (MT, 1, 2, 32)
        nt = np.arange(C // 8)[:, None, None]
        word = (m * cpr_t + swz(m, nt, cpr_t)) * 4 + Q                  # (MT, C/8, 2, 32)
        banks_distinct(word)
        v = acc.transpose(0, 2, 1, 3).reshape(16 * mt1, C) + b1
        tm = t0 - hc + np.arange(16 * mt1)
        v = np.where(((tm >= 0) & (tm < T))[:, None], bf16(lrelu(v)), 0).astype(np.float32)
        col = nt * 8 + 2 * Q
        t1 = np.full(16 * mt1_launch * C + 16 * C, np.nan, np.float32)  # then the ring's words
        t1[2 * word], t1[2 * word + 1] = v[m, col], v[m, col + 1]
        # ---- conv2 over rows [t0, t0 + 16 * mt2)
        acc = np.zeros((mt2, C // 8, 16, 8), np.float32)
        for ci in range(nch):
            for j in range(K):
                acc = bf16_stage_mma(acc, t1, j, ci * cpr_x, cpr_t, slots[(nch + ci) * K + j],
                                     g, C)
        # ---- acc + b2 -> the fp32 tile [C][st], row m at m + (t0 % 8)
        toff = t0 % 8
        tile = np.full(C * st, np.nan, np.float32)
        m = np.arange(mt2)[:, None, None, None] * 16 + G + 8 * np.arange(2)[:, None]
        col = np.arange(C // 8)[:, None, None] * 8 + 2 * Q
        d = acc.transpose(0, 2, 1, 3).reshape(16 * mt2, C) + b2
        for e in range(2):
            word = (col + e) * st + m + toff
            banks_distinct(word)
            tile[word] = d[m, col + e]
        # ---- bf16(x + tile): whole 8-time chunks [u0, u1) 16 bytes at a
        #      time (or two of 8), the other rows 2 bytes at a time
        u0, u1 = ((toff + 7) // 8, (toff + rows) // 8) if aligned else (0, 0)
        nw = max(u1 - u0, 0)
        i = np.arange(C * nw)            # thread i: whole chunk u of channel colv
        colv, u = i // max(nw, 1), u0 + i % max(nw, 1)
        assert ((colv * T + t0 + 8 * u - toff) % vec == 0).all()
        h = (i % 32 >> 2) & 1
        for s in range(2):               # a quarter warp's 16-byte reads of one channel
            lanes_distinct((colv * st + 8 * u + 4 * (h ^ s)) // 4 % 8, 8, colv)
        mh = min(rows, 8 * u0 - toff) if aligned else rows
        mtl = max(mh, 8 * u1 - toff) if aligned else rows
        ns = mh + rows - mtl             # the rows 2 bytes at a time, thread i: row e of channel
        colv, e = np.divmod(np.arange(C * ns), max(ns, 1))
        lanes_distinct((colv * st + np.where(e < mh, e, mtl + e - mh) + toff) % 32, 32, colv)
        cover = np.zeros(rows, int)      # each row written once
        cover[:mh] += 1
        cover[mtl:] += 1
        if nw:
            cover[8 * u0 - toff:8 * u1 - toff] += 1
        assert (cover == 1).all()
        out[:, t0:t0 + rows] = bf16(x[:, t0:t0 + rows] + tile.reshape(C, st)[:, toff:toff + rows])
    return out


def _bf16_case(C, k, seed):
    """One step's packed weights and biases, rounded to bf16: w (k, C, C),
    b (C,)."""
    return [bf16(n(a[0])) for a in packed_resblock(resblock_params(seed, k, C, 1))]


def _bf16_branch(x, w1, b1, w2, b2, k, dil):
    """x + _branch in bf16 on the same bf16 inputs, x (C, T)."""
    xt = t(x, torch.bfloat16)[None]
    wt = [t(a, torch.bfloat16) for a in (w1, b1, w2, b2)]
    return n((xt + trb._branch(xt, *wt, k, dil)).float())[0]


@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("k", [3, 7, 11])
def test_tc_bf16_fragment_model_matches_branch(C, k):
    """The model of the bf16 tensor-core kernel's step at its longest tile,
    T across two tiles and a ragged one: T odd (x staged and the output
    written 2 bytes at a time), T a multiple of 8 (16 bytes at a time;
    the tiles' seams off the 8-time grid) and T = 4 mod 8 (8 bytes at a
    time, as C = 256 at an odd number of frames), against x + _branch in bf16 on
    the same bf16 inputs: max abs <= 4 bf16 ulps of |ref|max (both
    accumulate in fp32; the plain chain also rounds each conv's output and
    the sum to bf16)."""
    dil = 3
    tt = 16 * TC_BF16_CFG[C][1] - (k - 1)
    w1, b1, w2, b2 = _bf16_case(C, k, C * k + 1)
    for T in (2 * tt + 37, 2 * tt + 8 - 2 * tt % 8, 2 * tt + 12 - 2 * tt % 8):
        x = bf16(resblock_x(T, C, b=1)[0].T)                  # (C, T)
        got = tc_bf16_step_model(x, w1, b1, w2, b2, k, dil, tt)
        ref = _bf16_branch(x, w1, b1, w2, b2, k, dil)
        err = np.abs(got - ref).max()
        assert np.isfinite(got).all() and np.array_equal(got, bf16(got))
        assert err <= BF16_ULPS * bf16_ulp(np.abs(ref).max()), (T, err)


@pytest.mark.parametrize("C,k", [(256, 3), (128, 7)])
def test_tc_bf16_model_tiles_agree_bitwise(C, k):
    """Every output sums the same products in the same order whatever the
    time tile: the model at two tiles gives the same bits (C = 256: 4 x 8
    warp tiles, one k16 step a stage; C = 128: two), within 4 bf16 ulps
    of x + _branch."""
    dil, T = 2, 200
    w1, b1, w2, b2 = _bf16_case(C, k, C + k)
    x = bf16(resblock_x(T, C, b=1)[0].T)
    outs = [tc_bf16_step_model(x, w1, b1, w2, b2, k, dil, tt)
            for tt in (16 * TC_BF16_CFG[C][1] - (k - 1), 40)]
    assert np.array_equal(outs[0], outs[1]) and np.isfinite(outs[0]).all()
    ref = _bf16_branch(x, w1, b1, w2, b2, k, dil)
    assert np.abs(outs[0] - ref).max() <= BF16_ULPS * bf16_ulp(np.abs(ref).max())


def test_tc_bf16_model_matches_pallas_bf16_interpret():
    """The model run over the D = 3 steps of a resblock, at the wrapper's
    time tile, against the JAX package's Pallas kernel in bf16 (interpret
    mode) on the same bf16 inputs and `pack_resblock_weights(dtype=
    bfloat16)` weights: max abs <= 4 bf16 ulps of |ref|max.  The Pallas
    kernel keeps x in fp32 across the dilations and rounds once at the
    end; the port's steps round x to bf16 between launches."""
    k, dils, C, T = 3, (1, 3, 5), 32, 304
    p = resblock_params(12, k, C, len(dils))
    x = bf16(resblock_x(T, C, b=2))                         # (B, T, C)
    w1, b1, w2, b2 = pack_resblock_weights(jax.tree_util.tree_map(jnp.asarray, p),
                                           kernel_size=k, dilations=dils, dtype=jnp.bfloat16)
    ref = np.asarray(pallas_resblock(jnp.asarray(x, jnp.bfloat16), w1, b1, w2, b2,
                                     kernel_size=k, dilations=dils, interpret=True,
                                     t_tile=256).astype(jnp.float32))
    pw = [np.asarray(a.astype(jnp.float32))[..., :C] for a in (w1, b1, w2, b2)]
    pw[0], pw[2] = pw[0][:, :, :C, :C], pw[2][:, :, :C, :C]
    tt = trb.tc_time_tile("tc_bf16", 2, T, C, k)
    got = []
    for row in x:
        y = row.T.copy()                                        # (C, T)
        for i, d in enumerate(dils):
            y = tc_bf16_step_model(y, pw[0][i], pw[1][i], pw[2][i], pw[3][i], k, d, tt)
        got.append(y.T)
    err = np.abs(np.stack(got) - ref).max()
    assert err <= BF16_ULPS * bf16_ulp(np.abs(ref).max()), err


def test_tc_bf16_geometry_fits_shared_memory():
    """Every (C, k, dil) the bf16 kernel takes, at every tile up to its
    longest, fits the 227 KB a block may use (where MINB blocks share an
    SM, 228 KB less 1 KB a block over MINB), its regions in order: the x
    image and raw chunk, or the intermediate, before the ring, conv2's
    reads up to k - 2 rows past the intermediate inside the ring, the fp32
    tile over them all; the raw chunk's rows an odd
    number of 16-byte chunks, the image's rows the window's plus the shift
    to 8-aligned time; conv1's rows cover conv2's halo.  Registers: every
    warp holds 2 x 2 tiles or
    more, and its accumulators with one k16 step's A and B fragments
    (and 24 for addresses) fit what a thread may hold with MINB blocks
    an SM (16,384 registers per sub-partition over its warps);
    `TC_BF16_TILES` mirrors `Cfg`."""
    for C in trb.SUPPORTED_C:
        for k in trb.SUPPORTED_K:
            g = tc_bf16_cfg(C, k)
            assert trb.TC_BF16_TILES[C] == (g["KC"], g["MT_MAX"], g["WM"], g["MINB"])
            assert g["NTW"] >= 2 and g["NTW"] % 2 == 0 and g["MTW"] >= 2
            assert g["NCH"] * g["KC"] == C and g["KC"] % 16 == 0 and g["RING"] >= 2
            assert g["NCH"] == 1 or g["RING"] <= k         # raw x reused once every warp staged it
            warps = g["MINB"] * g["THREADS"] // 32
            cap = min(255, 16384 // (32 * -(-warps // 4)) // 8 * 8)
            regs = 4 * g["MTW"] * g["NTW"] + 4 + 2 * g["NTW"]
            assert regs + 24 <= cap, (C, k, regs, cap)
            tt_max = 16 * g["MT_MAX"] - (k - 1)
            assert -(-(tt_max + k - 1) // 16) == g["MT_MAX"]
            for dil in range(1, trb.MAX_DILATION + 1):
                for tt in (17, tt_max // 2, tt_max):
                    mt1 = -(-(tt + k - 1) // 16)
                    L = tc_bf16_layout(C, k, mt1, dil)
                    limit = (SMEM_BLOCK if g["MINB"] == 1
                             else (SMEM_SM - 1024 * g["MINB"]) // g["MINB"])
                    assert L["total"] <= limit, (C, k, dil, tt, L["total"])
                    assert L["raw"] + g["KC"] * L["xrpc"] * 16 <= L["ring"]
                    assert L["t1"] >= 0 and L["t1"] + 16 * mt1 * C * 2 == L["ring"]
                    assert L["t1"] + (16 * mt1 + k - 1) * C * 2 <= L["ring_end"]
                    assert all(L[r] % 16 == 0 for r in ("raw", "t1", "ring"))
                    assert L["xrpc"] % 2 == 1 and L["xrpc"] >= L["ir"] // 8
                    assert L["ir"] >= 16 * mt1 + (k - 1) * dil + 7
                    assert 16 * mt1 >= tt + k - 1


def test_tc_bf16_time_tile_fills_the_card():
    """The bf16 kernel's time tile (`tc_time_tile` over `TC_BF16_TILES`) at
    every main-path stage and k, the decode's (B = 2 x 10 s) and
    training's (B = 8): the tiles cover [0, T) exactly, each within the
    kernel's m-tiles and at least 17 rows.  Where an SM holds one block (C
    = 256) the grid runs in whole waves: 264 blocks of 91 rows in
    conversion, one wave of 128 blocks of 27 rows in training.  Where it
    holds two (C <= 128) the grid has at least the 264 blocks the SMs
    hold."""
    for b, c, tlen, ks in _main_path_stages():
        _, mt_max, _, per_sm = trb.TC_BF16_TILES[c]
        for k in ks:
            tt = trb.tc_time_tile("tc_bf16", b, tlen, c, k)
            tiles = -(-tlen // tt)
            assert (tiles - 1) * tt < tlen <= tiles * tt
            assert min(17, tlen) <= tt and -(-(tt + k - 1) // 16) <= mt_max
            blocks = b * tiles
            if per_sm == 1:
                assert blocks <= trb.CARD_SMS or blocks % trb.CARD_SMS == 0, (b, c, tlen, k)
            else:
                assert blocks >= 2 * trb.CARD_SMS, (b, c, tlen, k, blocks)
    for b, tlen, blocks, rows in ((2, 11976, 264, 91), (8, 432, 128, 27)):
        tt = trb.tc_time_tile("tc_bf16", b, tlen, 256, 11)
        assert (tt, b * -(-tlen // tt)) == (rows, blocks)


def test_slope_pinned_reference_is_the_plain_chain_at_its_own_steps():
    """At the plain steps' own inputs no slope is pinned away: the output
    and the gradients equal the plain chain's."""
    k, dils, C, T = 7, (1, 3, 5), 32, 200
    p = resblock_params(4, k, C, len(dils))
    x = t(resblock_x(T, C)).transpose(1, 2).contiguous()
    leaves = [v.requires_grad_(True) for v in [x, *packed_resblock(p)]]
    xs = trb._forward_steps(*[v.detach() for v in leaves], k, dils)
    out, worst = trb._resblock_at_slopes(*leaves, kernel_size=k, dilations=dils,
                                         step_inputs=xs[:-1])
    ref = trb._resblock(*leaves, kernel_size=k, dilations=dils)
    assert worst == 0.0
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    cot = torch.ones_like(ref)
    for a, b in zip(torch.autograd.grad(out, leaves, cot), torch.autograd.grad(ref, leaves, cot)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_gradients_compare_at_pinned_slopes(monkeypatch):
    """A forward that differs from the plain chain by 1e-6 (as a kernel
    that sums in another order does) moves leaky_relu's slope wherever a
    pre-activation lies that close to 0, and the gradients then differ
    from the plain chain's by O(1) there.  Against the chain with the
    slopes pinned at that forward's step inputs they agree within 1e-4 x
    max(1, |ref|max), and every pinned slope sits at a pre-activation of
    rounding size."""
    k, dils, C, T = 7, (1, 3, 5), 128, 1000
    p = resblock_params(21, k, C, 3)
    x = t(resblock_x(T, C)).transpose(1, 2).contiguous()
    cot = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    leaves = [v.requires_grad_(True) for v in [x, *packed_resblock(p)]]

    def rounded_steps(x, w1, b1, w2, b2, kernel_size, dilations):
        xs = [x]
        for i, d in enumerate(dilations):
            y = xs[-1] + trb._branch(xs[-1], w1[i], b1[i], w2[i], b2[i], kernel_size, d)
            noise = torch.randn(y.shape, generator=torch.Generator().manual_seed(i))
            xs.append(y + 1e-6 * noise)
        return xs

    monkeypatch.setattr(trb, "_forward_steps", rounded_steps)
    got = torch.autograd.grad(trb.fused_resblock(*leaves, kernel_size=k, dilations=dils),
                              leaves, cot)
    plain = torch.autograd.grad(trb._resblock(*leaves, kernel_size=k, dilations=dils),
                                leaves, cot)
    xs = rounded_steps(*[v.detach() for v in leaves], k, dils)
    out, worst = trb._resblock_at_slopes(*leaves, kernel_size=k, dilations=dils,
                                         step_inputs=xs[:-1])
    pinned = torch.autograd.grad(out, leaves, cot)
    assert 0.0 < worst <= 1e-5
    tol = [1e-4 * max(1.0, r.abs().max().item()) for r in plain]
    assert any((a - r).abs().max().item() > e for a, r, e in zip(got, plain, tol))
    for a, r, e in zip(got, pinned, tol):
        assert (a - r).abs().max().item() <= e


def test_autograd_matches_plain_chain_grads():
    """The recomputing backward equals autograd through the plain chain."""
    k, dils, C, T = 3, (1, 2), 32, 64
    p = resblock_params(9, k, C, len(dils))
    x = t(resblock_x(T, C)).transpose(1, 2).contiguous()
    grads = []
    for fn in (trb.fused_resblock, trb._resblock):
        xi = x.clone().requires_grad_(True)
        ws = [a.requires_grad_(True) for a in packed_resblock(p)]
        fn(xi, *ws, kernel_size=k, dilations=dils).square().sum().backward()
        grads.append([n(v.grad) for v in (xi, *ws)])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
