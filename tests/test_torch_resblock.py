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
# kernel tiles it, with the m16n8k4 TF32 fragment maps and 3xTF32.  The
# kernel's index arithmetic is written from this model.
# ---------------------------------------------------------------------------

LANE = np.arange(32)
G, Q = LANE >> 2, LANE & 3           # groupID, thread in group


def tf32_rna(v):
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    bits = np.asarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(v):
    hi = tf32_rna(v)
    return hi, tf32_rna(np.asarray(v, np.float32) - hi)


def stride8(n):
    """Smallest row stride >= n that is 8 mod 32 words."""
    return n + (8 - n) % 32


def tc_geometry(C, K):
    tt = 16384 // C                  # 8 rows x 256 threads / (C / 8)
    hc = (K - 1) // 2
    m1 = -(-(tt + 2 * hc) // 16) * 16
    wn = min(8, C // 8)
    return dict(TT=tt, HC=hc, M1=m1, MT1=m1 // 16, MT2=tt // 16, WN=wn, WM=8 // wn,
                NTW=C // 8 // wn, CS=C + 8, S1=stride8(m1), TTP=tt + 4)


def mma_tf32(acc, a0, a1, b0):
    """mma.sync.m16n8k4 f32.tf32.tf32.f32 over a warp's tiles.  a0, a1:
    (MT, 32) per lane, b0: (NT, 32); acc: (MT, NT, 32, 4) per lane.
    A[g][q] = a0, A[g + 8][q] = a1; B[q][g] = b0; c0..c3 = D at (g, 2q),
    (g, 2q + 1), (g + 8, 2q), (g + 8, 2q + 1)."""
    a = np.zeros((a0.shape[0], 16, 4))
    a[:, G, Q], a[:, G + 8, Q] = a0, a1
    b = np.zeros((b0.shape[0], 4, 8))
    b[:, Q, G] = b0
    d = np.einsum("mik,nkj->mnij", a, b)          # products of tf32 are exact
    c = np.stack([d[:, :, G, 2 * Q], d[:, :, G, 2 * Q + 1],
                  d[:, :, G + 8, 2 * Q], d[:, :, G + 8, 2 * Q + 1]], -1)
    return (acc + c).astype(np.float32)


def mma_3xtf32(acc, a0, a1, b0):
    """The three passes, small terms first: lo x hi, hi x lo, hi x hi."""
    (a0h, a0l), (a1h, a1l), (bh, bl) = split_tf32(a0), split_tf32(a1), split_tf32(b0)
    acc = mma_tf32(acc, a0l, a1l, bh)
    acc = mma_tf32(acc, a0h, a1h, bl)
    return mma_tf32(acc, a0h, a1h, bh)


def warp_tiles(warp, g, mt_total):
    """A warp's m-tiles (every WM-th, from wm) and n-tiles (NTW in a row)."""
    wn, wm = warp % g["WN"], warp // g["WN"]
    mts = np.arange(wm, mt_total, g["WM"])
    nts = wn * g["NTW"] + np.arange(g["NTW"])
    return mts, nts


def assert_banks_distinct(addr):
    assert len(set((np.asarray(addr) % 32).tolist())) == 32, addr


def tc_step_model(x, w1, b1, w2, b2, K, dil):
    """One step of one batch row, x (C, T) -> x + conv2(lrelu(conv1(lrelu(x)))),
    through shared-memory images laid out as the kernel lays them out.
    Words the kernel never writes hold NaN, so a fragment that reads one
    poisons the result."""
    C, T = x.shape
    g = geom = tc_geometry(C, K)
    TT, HC, M1, CS, S1 = g["TT"], g["HC"], g["M1"], g["CS"], g["S1"]
    lrelu = lambda v: np.where(v >= 0, v, np.float32(0.1) * v).astype(np.float32)
    xr = M1 + (K - 1) * dil
    xrs = stride8(xr)
    out = np.empty_like(x)

    def stage_w(w, s):               # [K][kCI][CS], columns C..CS unwritten
        ws = np.full((K, 4, CS), np.nan, np.float32)
        ws[:, :, :C] = w[:, 4 * s:4 * s + 4, :]
        return ws.ravel()

    def b_frags(ws, j, nts):         # b0 = B[q][g] = w[j][ci0 + q][nt * 8 + g]
        addr = (j * 4 + Q) * CS + nts[:, None] * 8 + G
        assert_banks_distinct(addr[0])
        return ws[addr]

    for t0 in range(0, T, TT):
        xstart = t0 - HC - HC * dil
        # ---- conv1 over rows [t0 - HC, t0 - HC + M1)
        acc1 = {w: np.zeros((len(warp_tiles(w, g, g["MT1"])[0]), g["NTW"], 32, 4),
                            np.float32) for w in range(8)}
        for s in range(C // 4):
            xs = np.full(4 * xrs, np.nan, np.float32)        # [kCI][xrs]
            for cc in range(4):
                tt = xstart + np.arange(xr)
                ok = (tt >= 0) & (tt < T)
                xs[cc * xrs + np.arange(xr)] = np.where(
                    ok, lrelu(x[4 * s + cc, np.clip(tt, 0, T - 1)]), 0.0)
            ws = stage_w(w1, s)
            for w in range(8):
                mts, nts = warp_tiles(w, g, g["MT1"])
                for j in range(K):
                    row = Q * xrs + mts[:, None] * 16 + G + j * dil
                    assert_banks_distinct(row[0])
                    acc1[w] = mma_3xtf32(acc1[w], xs[row], xs[row + 8], b_frags(ws, j, nts))
        # ---- + b1, zero outside [0, T), lrelu -> t1s [C][S1]
        t1s = np.full(C * S1, np.nan, np.float32)
        for w in range(8):
            mts, nts = warp_tiles(w, g, g["MT1"])
            for r in range(4):
                m = mts[:, None, None] * 16 + G + 8 * (r >> 1)        # (MT, 1, 32)
                nn = nts[None, :, None] * 8 + 2 * Q + (r & 1)         # (1, NT, 32)
                tm = t0 - HC + m
                v = lrelu(acc1[w][..., r] + b1[nn])
                t1s[nn * S1 + m] = np.where((tm >= 0) & (tm < T), v, 0.0)
        # ---- conv2 over rows [t0, t0 + TT), A from t1s offset by j rows
        acc2 = {w: np.zeros((len(warp_tiles(w, g, g["MT2"])[0]), g["NTW"], 32, 4),
                            np.float32) for w in range(8)}
        for s in range(C // 4):
            ws = stage_w(w2, s)
            for w in range(8):
                mts, nts = warp_tiles(w, g, g["MT2"])
                for j in range(K):
                    row = (4 * s + Q) * S1 + mts[:, None] * 16 + G + j
                    assert_banks_distinct(row[0])
                    acc2[w] = mma_3xtf32(acc2[w], t1s[row], t1s[row + 8],
                                         b_frags(ws, j, nts))
        # ---- + b2 into tile [C][TTP], then x + tile along time
        tile = np.full(C * g["TTP"], np.nan, np.float32)
        for w in range(8):
            mts, nts = warp_tiles(w, g, g["MT2"])
            for r in range(4):
                m = mts[:, None, None] * 16 + G + 8 * (r >> 1)
                nn = nts[None, :, None] * 8 + 2 * Q + (r & 1)
                tile[nn * g["TTP"] + m] = acc2[w][..., r] + b2[nn]
        n_rows = min(TT, T - t0)
        tile = tile.reshape(C, g["TTP"])[:, :n_rows]
        out[:, t0:t0 + n_rows] = x[:, t0:t0 + n_rows] + tile
    assert geom["MT1"] * 16 >= TT + 2 * HC
    return out


@pytest.mark.parametrize("C", [16, 32])
@pytest.mark.parametrize("k", [3, 7])
def test_tc_fragment_model_matches_branch(C, k):
    """The model of the tensor-core kernel's step, at T across two time
    tiles, against x + _branch: <= 1e-5 x max(1, |ref|max)."""
    dil = 3
    T = tc_geometry(C, k)["TT"] + 37
    p = resblock_params(C * k, k, C, 1)
    w1, b1, w2, b2 = (n(a[0]) for a in packed_resblock(p))
    x = resblock_x(T, C, b=1)[0].T.copy()                   # (C, T)
    got = tc_step_model(x, w1, b1, w2, b2, k, dil)
    xt = t(x)[None]
    ref = n(xt + trb._branch(xt, t(w1), t(b1), t(w2), t(b2), k, dil))[0]
    err = np.abs(got - ref).max()
    assert np.isfinite(got).all() and err <= 1e-5 * max(1.0, np.abs(ref).max()), err


def test_tc_geometry_fits_shared_memory():
    """Every (C, k, dil) the kernel takes fits the 227 KB a block may use,
    with the conv2 output tile inside the intermediate's buffer."""
    for C in trb.SUPPORTED_C:
        for k in trb.SUPPORTED_K:
            g = tc_geometry(C, k)
            assert g["TTP"] <= g["S1"] and g["M1"] <= g["S1"] and g["TT"] % 16 == 0
            for dil in range(1, trb.MAX_DILATION + 1):
                xrs = stride8(g["M1"] + (k - 1) * dil)
                smem = 4 * (2 * k * 4 * g["CS"] + C * g["S1"] + 2 * 4 * xrs)
                assert smem <= 232448, (C, k, dil, smem)


def test_three_tf32_passes_hold_fp32_accuracy():
    """One k = 11, C = 256 conv over 64 rows, summed as the kernel sums it
    (4 channels x one tap per MMA, the fp32 accumulator rounded after each
    of the 704 x 3 MMAs), relative to the fp64 result's max.  3xTF32
    stays within 3x of fp32 FMA summed in the same order (about 1e-6
    each) and within 1e-5; 1xTF32 does not stay within 1e-4, the kernel
    check's tolerance.  That is why the kernel takes three passes."""
    K, C, M = 11, 256, 64
    rs = np.random.RandomState(0)
    a = rs.randn(M + K - 1, C).astype(np.float32) * np.float32(0.3)
    a = np.where(a >= 0, a, np.float32(0.1) * a).astype(np.float32)
    w = (rs.randn(K, C, C) * (0.5 / np.sqrt(K * C))).astype(np.float32)
    ref = sum(a[j:j + M].astype(np.float64) @ w[j].astype(np.float64) for j in range(K))
    errs = {}
    for method in ("fp32", "1xtf32", "3xtf32"):
        acc = np.zeros((M, C), np.float32)
        for s in range(C // 4):
            for j in range(K):
                aa, bb = a[j:j + M, 4 * s:4 * s + 4], w[j, 4 * s:4 * s + 4]
                (ah, al), (bh, bl) = split_tf32(aa), split_tf32(bb)
                terms = {"fp32": [(aa, bb)], "1xtf32": [(ah, bh)],
                         "3xtf32": [(al, bh), (ah, bl), (ah, bh)]}[method]
                for u, v in terms:
                    acc = (acc + u.astype(np.float64) @ v.astype(np.float64)).astype(np.float32)
        errs[method] = np.abs(acc - ref).max() / np.abs(ref).max()
    assert errs["3xtf32"] <= min(1e-5, 3 * errs["fp32"]), errs
    assert errs["1xtf32"] > 1e-4, errs


# ---------------------------------------------------------------------------
# A numpy model of csrc/resblock_tc_bf16.cu: one dilation step in bf16,
# tiled as the kernel tiles it, with the m16n8k8 bf16 fragment maps, the
# [channel pair][row] word images of lrelu(x) and of the intermediate,
# and the weights' B fragments as ldmatrix.trans reads them.
# ---------------------------------------------------------------------------

def bf16(v):
    """Round fp32 to bf16 (to nearest, ties to even), kept as fp32."""
    bits = np.asarray(v, np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return bits.view(np.float32)


def tc_bf16_geometry(C, K):
    tt = 16384 // C
    hc = (K - 1) // 2
    m1 = -(-(tt + 2 * hc) // 16) * 16
    ntw = min(4, C // 8)
    wn = C // 8 // ntw
    return dict(TT=tt, HC=hc, M1=m1, MT1=m1 // 16, MT2=tt // 16, NTW=ntw, WN=wn, WM=8 // wn,
                CS=C + 8, S1=stride8(m1), TTP=tt + 4, NSTEP=C // 8)


def mma_bf16(acc, a0, a1, b0):
    """mma.sync.m16n8k8 f32.bf16.bf16.f32 over a warp's tiles.  Each
    operand register is a (low, high) pair of bf16 values: a0, a1 (MT,
    32) per lane, b0 (NT, 32).  A[g][2q + i] = a0[i], A[g + 8][2q + i] =
    a1[i]; B[2q + i][g] = b0[i]; c0..c3 as in m16n8k4."""
    a = np.zeros((a0[0].shape[0], 16, 8))
    for i in range(2):
        a[:, G, 2 * Q + i], a[:, G + 8, 2 * Q + i] = a0[i], a1[i]
    b = np.zeros((b0[0].shape[0], 8, 8))
    for i in range(2):
        b[:, 2 * Q + i, G] = b0[i]
    d = np.einsum("mik,nkj->mnij", a, b)          # products of bf16 are exact
    c = np.stack([d[:, :, G, 2 * Q], d[:, :, G, 2 * Q + 1],
                  d[:, :, G + 8, 2 * Q], d[:, :, G + 8, 2 * Q + 1]], -1)
    return (acc + c).astype(np.float32)


def tc_bf16_step_model(x, w1, b1, w2, b2, K, dil):
    """One bf16 step of one batch row, x (C, T) of bf16 values ->
    bf16(x + conv2(bf16(lrelu(conv1(bf16(lrelu(x))))))), through shared-
    memory images laid out as the kernel lays them out.  A word image is
    a (low, high) pair of arrays; words and weights the kernel never
    writes hold NaN, so a fragment that reads one poisons the result."""
    C, T = x.shape
    g = tc_bf16_geometry(C, K)
    TT, HC, M1, CS, S1, TTP = g["TT"], g["HC"], g["M1"], g["CS"], g["S1"], g["TTP"]
    lrelu = lambda v: np.where(v >= 0, v, np.float32(0.1) * v).astype(np.float32)
    xr = M1 + (K - 1) * dil
    xrs = stride8(xr)
    out = np.empty_like(x)

    def stage_w(w, s):               # [K][kCI][CS] bf16, columns C..CS unwritten
        ws = np.full((K, 8, CS), np.nan, np.float32)
        ws[:, :, :C] = w[:, 8 * s:8 * s + 8, :]
        return ws.ravel()

    def b_frags(ws, j, nts):
        """ldmatrix.trans: lanes 8i..8i+7 give n-tile i's rows k = 0..7 at
        element (j * 8 + k) * CS + nt * 8; lane (g, q) receives rows 2q and
        2q + 1 of column g.  Each 8-row read covers 32 distinct banks."""
        rows = (j * 8 + np.arange(8))[None, :] * CS + nts[:, None] * 8       # (NT, 8)
        for r in rows:
            assert r.min() % 8 == 0 and (CS * 2) % 16 == 0          # 16-byte rows
            assert_banks_distinct((r[:, None] // 2 + np.arange(4)).ravel())
        return tuple(ws[rows[:, 2 * Q + i] + G] for i in range(2))

    def a_frags(lo, hi, addr):
        assert_banks_distinct(addr[0])
        assert_banks_distinct(addr[0] + 8)
        return (lo[addr], hi[addr]), (lo[addr + 8], hi[addr + 8])

    for t0 in range(0, T, TT):
        xstart = t0 - HC - HC * dil
        # ---- conv1 over rows [t0 - HC, t0 - HC + M1)
        acc1 = {w: np.zeros((len(warp_tiles(w, g, g["MT1"])[0]), g["NTW"], 32, 4),
                            np.float32) for w in range(8)}
        for s in range(g["NSTEP"]):
            xlo, xhi = (np.full(4 * xrs, np.nan, np.float32) for _ in range(2))  # [kCP][xrs]
            tt = xstart + np.arange(xr)
            ok = (tt >= 0) & (tt < T)
            for p in range(4):
                for half, c in ((xlo, 8 * s + 2 * p), (xhi, 8 * s + 2 * p + 1)):
                    half[p * xrs + np.arange(xr)] = np.where(
                        ok, bf16(lrelu(x[c, np.clip(tt, 0, T - 1)])), 0.0)
            ws = stage_w(w1, s)
            for w in range(8):
                mts, nts = warp_tiles(w, g, g["MT1"])
                for j in range(K):
                    a0, a1 = a_frags(xlo, xhi, Q * xrs + mts[:, None] * 16 + G + j * dil)
                    acc1[w] = mma_bf16(acc1[w], a0, a1, b_frags(ws, j, nts))
        # ---- bf16(lrelu(+ b1)), 0 outside [0, T) -> t1s [C/2][S1] words
        tlo, thi = (np.full(C // 2 * S1, np.nan, np.float32) for _ in range(2))
        for w in range(8):
            mts, nts = warp_tiles(w, g, g["MT1"])
            for h in range(2):
                m = mts[:, None, None] * 16 + G + 8 * h                # (MT, 1, 32)
                nn = nts[None, :, None] * 8 + 2 * Q                   # (1, NT, 32)
                addr = (nn // 2) * S1 + m
                assert_banks_distinct(addr[0, 0])
                seq = (t0 - HC + m >= 0) & (t0 - HC + m < T)
                for half, r, dn in ((tlo, 2 * h, 0), (thi, 2 * h + 1, 1)):
                    v = bf16(lrelu(acc1[w][..., r] + b1[nn + dn]))
                    half[addr] = np.where(seq, v, 0.0)
        # ---- conv2 over rows [t0, t0 + TT), A from t1s offset by j rows
        acc2 = {w: np.zeros((len(warp_tiles(w, g, g["MT2"])[0]), g["NTW"], 32, 4),
                            np.float32) for w in range(8)}
        for s in range(g["NSTEP"]):
            ws = stage_w(w2, s)
            for w in range(8):
                mts, nts = warp_tiles(w, g, g["MT2"])
                for j in range(K):
                    a0, a1 = a_frags(tlo, thi, (4 * s + Q) * S1 + mts[:, None] * 16 + G + j)
                    acc2[w] = mma_bf16(acc2[w], a0, a1, b_frags(ws, j, nts))
        # ---- + b2 into an fp32 tile [C][TTP], then bf16(x + tile) along time
        tile = np.full(C * TTP, np.nan, np.float32)
        for w in range(8):
            mts, nts = warp_tiles(w, g, g["MT2"])
            for r in range(4):
                m = mts[:, None, None] * 16 + G + 8 * (r >> 1)
                nn = nts[None, :, None] * 8 + 2 * Q + (r & 1)
                assert_banks_distinct((nn * TTP + m)[0, 0])
                tile[nn * TTP + m] = acc2[w][..., r] + b2[nn]
        n_rows = min(TT, T - t0)
        tile = tile.reshape(C, TTP)[:, :n_rows]
        out[:, t0:t0 + n_rows] = bf16(x[:, t0:t0 + n_rows] + tile)
    return out


@pytest.mark.parametrize("C", [16, 32])
@pytest.mark.parametrize("k", [3, 7])
def test_tc_bf16_fragment_model_matches_branch(C, k):
    """The model of the bf16 tensor-core kernel's step, at T across two
    time tiles, against x + _branch in bf16 on the same bf16 inputs: max
    abs <= 4 bf16 ulps of |ref|max (both accumulate in fp32; the plain
    chain also rounds each conv's output and the sum to bf16)."""
    dil = 3
    T = tc_bf16_geometry(C, k)["TT"] + 37
    p = resblock_params(C * k + 1, k, C, 1)
    w1, b1, w2, b2 = (bf16(n(a[0])) for a in packed_resblock(p))
    x = bf16(resblock_x(T, C, b=1)[0].T)                  # (C, T)
    got = tc_bf16_step_model(x, w1, b1, w2, b2, k, dil)
    xt, wt = t(x, torch.bfloat16)[None], [t(a, torch.bfloat16) for a in (w1, b1, w2, b2)]
    ref = n((xt + trb._branch(xt, *wt, k, dil)).float())[0]
    err = np.abs(got - ref).max()
    assert np.isfinite(got).all() and np.array_equal(got, bf16(got))
    assert err <= BF16_ULPS * bf16_ulp(np.abs(ref).max()), err


def test_tc_bf16_model_matches_pallas_bf16_interpret():
    """The model run over the D = 3 steps of a resblock against the JAX
    package's Pallas kernel in bf16 (interpret mode) on the same bf16
    inputs and `pack_resblock_weights(dtype=bfloat16)` weights: max abs
    <= 4 bf16 ulps of |ref|max.  The Pallas kernel keeps x in fp32
    across the dilations and rounds once at the end; the port's steps
    round x to bf16 between launches."""
    k, dils, C, T = 3, (1, 3, 5), 32, 300
    p = resblock_params(12, k, C, len(dils))
    x = bf16(resblock_x(T, C, b=2))                         # (B, T, C)
    w1, b1, w2, b2 = pack_resblock_weights(jax.tree_util.tree_map(jnp.asarray, p),
                                           kernel_size=k, dilations=dils, dtype=jnp.bfloat16)
    ref = np.asarray(pallas_resblock(jnp.asarray(x, jnp.bfloat16), w1, b1, w2, b2,
                                     kernel_size=k, dilations=dils, interpret=True,
                                     t_tile=256).astype(jnp.float32))
    pw = [np.asarray(a.astype(jnp.float32))[..., :C] for a in (w1, b1, w2, b2)]
    pw[0], pw[2] = pw[0][:, :, :C, :C], pw[2][:, :, :C, :C]
    got = []
    for row in x:
        y = row.T.copy()                                        # (C, T)
        for i, d in enumerate(dils):
            y = tc_bf16_step_model(y, pw[0][i], pw[1][i], pw[2][i], pw[3][i], k, d)
        got.append(y.T)
    err = np.abs(np.stack(got) - ref).max()
    assert err <= BF16_ULPS * bf16_ulp(np.abs(ref).max()), err


def test_tc_bf16_geometry_fits_shared_memory():
    """Every (C, k, dil) the bf16 kernel takes fits the 227 KB a block may
    use (the kernel's `launch`: the staging buffers, or the fp32 output
    tile laid over them after conv2, whichever is larger); conv1's rows
    cover conv2's halo, the intermediate's row stride holds them, and
    NSTEP is even (the weight ring alternates per step)."""
    for C in trb.SUPPORTED_C:
        for k in trb.SUPPORTED_K:
            g = tc_bf16_geometry(C, k)
            assert g["M1"] >= g["TT"] + 2 * g["HC"] and g["M1"] <= g["S1"]
            assert g["TT"] % 32 == 0 and g["NSTEP"] % 2 == 0
            assert g["WN"] * g["NTW"] * 8 == C and 8 % g["WN"] == 0
            for dil in range(1, trb.MAX_DILATION + 1):
                xrs = stride8(g["M1"] + (k - 1) * dil)
                staging = 2 * 2 * k * 8 * g["CS"] + 4 * (C // 2 * g["S1"] + 2 * 4 * xrs)
                smem = max(staging, 4 * C * g["TTP"])
                assert smem <= 232448, (C, k, dil, smem)


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
