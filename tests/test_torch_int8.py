"""The port's int8 W8A8 mode against the JAX package's, on the CPU.

`rvc_maker_tpu_torch/ops/int8_conv.py` against `rvc_maker_tpu/ops/int8_conv.py`:
the quantizers bitwise, the W8A8 ops within 1e-6 relative on fp32 inputs
(the accumulation is exact int32) and within one bf16 ulp of |ref|max on
bf16 inputs.  The int8 decode at JAX's calibrated scales and noise (corr >
0.99), each package's int8 decode against its own bf16 decode at JAX's
gate (corr > 0.98, relative L2 < 0.2, `tests/test_int8_decode.py`), the
calibrated scales (2e-2 relative), HuBERT's int8 features (corr > 0.995),
RMVPE's int8 salience and `convert_batch` with RVC_TPU_INT8=1 (corr >
0.98).  Then the gates, the scope, the fallbacks, the audit, the served
500, and numpy models of the index arithmetic of csrc/conv1d_w8a8.cu and
csrc/conv1d_w8a8_ws.cu (the route) held bitwise against the kernels'
plain version, with the latter's division and shared-memory layout (the
kernels themselves run on the card: tests/test_torch_gpu.py,
chip_smoke.py phase 14).  Distances are printed (-s).
"""

import dataclasses
import inspect
import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu.config import ModelConfig as JaxModelConfig
from rvc_maker_tpu.models import hubert as jax_hubert
from rvc_maker_tpu.models import synthesizer as jax_syn
from rvc_maker_tpu.ops import int8_conv as jq
from rvc_maker_tpu.pipelines.convert import ConvertPipeline as JaxPipeline
from rvc_maker_tpu.pipelines.convert import ConvertSettings as JaxSettings
from rvc_maker_tpu_torch.config import ModelConfig
from rvc_maker_tpu_torch.interop import from_jax
from rvc_maker_tpu_torch.models import hubert as hubert_mod
from rvc_maker_tpu_torch.models import rmvpe as rmvpe_mod
from rvc_maker_tpu_torch.models import synthesizer as syn
from rvc_maker_tpu_torch.ops import int8_conv as tq
from rvc_maker_tpu_torch.ops.nn import cast_floats
from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline, ConvertSettings
from torch_port_util import bf16_ulp, jax_noise, jax_to_torch, n, torch_threads, tree_np  # noqa: F401

# tests/test_int8_decode.py's config (stages C = 128, 64, 32: two take int8)
# with v2 features
JCFG = JaxModelConfig(
    spec_channels=129, segment_size=16, inter_channels=64, hidden_channels=64,
    filter_channels=128, n_heads=2, n_layers=1, kernel_size=3,
    resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3), (1, 3)),
    upsample_rates=(5, 4, 2), upsample_initial_channel=256,
    upsample_kernel_sizes=(10, 8, 4), spk_embed_dim=4, gin_channels=32,
    sr=16000, use_f0=True, text_enc_hidden_dim=768)
CFG = ModelConfig(**dataclasses.asdict(JCFG))
RMVPE_WIDTHS = dict(widths=(4, 8, 16, 32, 64), inter_width=128)
N_SITES = 16            # 2 stages x 2 resblocks x 2 dilations x 2 convs
CORR_GATE, REL_GATE = 0.98, 0.2     # tests/test_int8_decode.py:93-94


def _corr(a, b):
    a, b = np.ravel(a), np.ravel(b)
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def _rel(a, b):
    return float(np.linalg.norm(np.ravel(a) - np.ravel(b)) / max(np.linalg.norm(b), 1e-12))


def _f32(x):
    """A JAX or torch array -> fp32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(a, dtype):
    """numpy fp32 -> (JAX array, CPU tensor) of the same values in dtype."""
    if dtype == "bf16":
        return jnp.asarray(a, jnp.bfloat16), torch.as_tensor(a).bfloat16()
    return jnp.asarray(a), torch.as_tensor(a)


@pytest.fixture(scope="module")
def trees():
    """JAX `tests/test_int8_decode.py`'s weights: the synthesizer from
    PRNGKey(0), a 2-layer HuBERT from PRNGKey(1); a narrow RMVPE."""
    return {"synth": jax_syn.init_params(jax.random.PRNGKey(0), JCFG),
            "hubert": jax_hubert.init_params(jax.random.PRNGKey(1), n_layers=2),
            "rmvpe": from_jax.random_rmvpe_tree(seed=2, **RMVPE_WIDTHS)}


# ---------------------------------------------------------------------------
# quantizers and ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["conv1d", "linear", "conv2d"])
def test_quantizers_match_jax_bitwise(kind, dtype):
    """Codes and scales equal bitwise, each package in its own layout."""
    rs = np.random.RandomState(len(kind))
    if kind == "conv1d":                  # packed (D, k, C_in, C_out); JAX per conv
        w = (rs.randn(2, 7, 64, 96) * 0.05).astype(np.float32)
        wj, wt = _pair(w, dtype)
        ref = [jq.quantize_weight(wj[d]) for d in range(2)]
        ref_q, ref_s = np.stack([np.asarray(r[0]) for r in ref]), np.stack([r[1] for r in ref])
        got_q, got_s = tq.quantize_weight(wt)
    elif kind == "linear":                # port (C_out, C_in); JAX (C_in, C_out)
        w = (rs.randn(96, 64) * 0.1).astype(np.float32)
        wj, wt = _pair(w, dtype)
        ref_q, ref_s = jq.quantize_linear_weight(wj.T)
        got_q, got_s = tq.quantize_linear_weight(wt)
        got_q = got_q.T
    else:                                 # port OIHW; JAX HWIO
        w = (rs.randn(128, 128, 3, 3) * 0.05).astype(np.float32)
        wj, wt = _pair(w, dtype)
        ref_q, ref_s = jq.quantize_conv2d_weight(wj.transpose(2, 3, 1, 0))
        got_q, got_s = tq.quantize_conv2d_weight(wt)
        got_q = got_q.permute(2, 3, 1, 0)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(n(got_q), np.asarray(ref_q))
    np.testing.assert_array_equal(n(got_s), np.asarray(ref_s))


def _op_case(op, dtype):
    """(JAX result, port result) of one W8A8 op on the same inputs."""
    rs = np.random.RandomState(11)
    if op in ("conv1d", "conv1d_fused"):
        x = (rs.randn(2, 300, 128) * 0.5).astype(np.float32)       # JAX (B, T, C)
        w = (rs.randn(7, 128, 128) * 0.05).astype(np.float32)      # (k, C_in, C_out)
        b = (rs.randn(128) * 0.01).astype(np.float32)
        r = (rs.randn(2, 300, 128) * 0.3).astype(np.float32)
        xj, xt = _pair(x, dtype)
        bj, bt = _pair(b, dtype)
        rj, rt = _pair(r, dtype)
        w_q, w_s = jq.quantize_weight(jnp.asarray(w))
        wq_t = torch.as_tensor(np.array(w_q)).permute(0, 2, 1).contiguous()
        ws_t = torch.as_tensor(np.asarray(w_s))
        xt, rt = xt.transpose(1, 2).contiguous(), rt.transpose(1, 2).contiguous()
        if op == "conv1d":                # a given scale, as a static site plays it
            s = np.float32(0.021)
            ref = jq.conv1d_w8a8(xj, w, bj, dilation=3, padding=9, w_q=w_q, w_scale=w_s,
                                 a_scale=jnp.float32(s))
            got = tq.conv1d_w8a8(xt, wq_t, ws_t, bt, a_scale=torch.tensor([s]), dilation=3)
        else:                             # leaky ReLU, dynamic scale, residual
            from rvc_maker_tpu.ops.nn import leaky_relu

            ref = jq.conv1d_w8a8(leaky_relu(xj, 0.1), w, bj, dilation=3, padding=9, w_q=w_q,
                                 w_scale=w_s) + rj
            got = tq.conv1d_w8a8(xt, wq_t, ws_t, bt, dilation=3, apply_lrelu=True, residual=rt)
        return _f32(ref), _f32(got.transpose(1, 2))
    if op == "linear":
        x = rs.randn(4, 17, 64).astype(np.float32)
        w = (rs.randn(96, 64) * 0.1).astype(np.float32)
        b = (rs.randn(96) * 0.01).astype(np.float32)
        (xj, xt), (wj, wt), (bj, bt) = (_pair(v, dtype) for v in (x, w, b))
        return _f32(jq.linear_w8a8(xj, wj.T, bj)), _f32(tq.linear_w8a8(xt, wt, bt))
    x = (rs.randn(2, 12, 10, 128) * 0.5).astype(np.float32)          # JAX NHWC
    w = (rs.randn(96, 128, 3, 3) * 0.05).astype(np.float32)          # OIHW
    (xj, xt), (wj, wt) = _pair(x, dtype), _pair(w, dtype)
    ref = jq.conv2d_w8a8(xj, wj.transpose(2, 3, 1, 0))
    got = tq.conv2d_w8a8(xt.permute(0, 3, 1, 2).contiguous(), wt)
    return _f32(ref), _f32(got.permute(0, 2, 3, 1))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("op", ["conv1d", "conv1d_fused", "linear", "conv2d"])
def test_w8a8_ops_match_jax(op, dtype):
    """fp32: within 1e-6 of |ref|max; bf16: within one bf16 ulp of it."""
    ref, got = _op_case(op, dtype)
    err, top = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    tol = 1e-6 * top if dtype == "fp32" else bf16_ulp(top)
    print(f"\n{op} {dtype}: max abs {err:.3e} (tol {tol:.3e}), "
          f"{int((got != ref).sum())} of {ref.size} differ")
    assert got.shape == ref.shape and err <= tol, (err, tol)


# ---------------------------------------------------------------------------
# a numpy model of csrc/conv1d_w8a8.cu
# ---------------------------------------------------------------------------

LANE = np.arange(32)
G, Q = LANE >> 2, LANE & 3          # groupID, thread in group
UNWRITTEN = 1000                     # a shared byte the kernel never writes
K_SLOPE = np.float32(0.10009765625)  # 0.1 rounded to bf16


def bf16(v):
    return torch.as_tensor(np.asarray(v, np.float32)).bfloat16().float().numpy()


def assert_banks_distinct(byte_addr):
    assert (np.asarray(byte_addr) % 4 == 0).all()
    assert len(set(((np.asarray(byte_addr) // 4) % 32).tolist())) == 32, byte_addr


def w8a8_geometry(C):
    wm = C // 64
    wn = 8 // wm
    return dict(WM=wm, WN=wn, TT=wn * 32, RS=C + 16)


def w8a8_kernel_model(x, w_q, w_scale, bias, a_scale, *, K, dil, lrelu, residual):
    """The kernel on (B, C, T) bf16 values (fp32 numpy), block by block:
    the quantized window staged time-major as 32-bit words of 4 channels,
    each tap's (C_out, C_in) weights in rows of RS bytes, the m16n8k32 s8
    fragments read lane by lane at the kernel's byte offsets (every read
    checked for bank conflicts and for unwritten bytes), and the epilogue
    writing each accumulator where c0..c3 say."""
    B, C, T = x.shape
    geo = w8a8_geometry(C)
    WM, TT, RS = geo["WM"], geo["TT"], geo["RS"]
    span = (K - 1) * dil
    rows = TT + span
    s = np.float32(a_scale)
    out = np.full(x.shape, np.nan, np.float32)
    for b in range(B):
        for t0 in range(0, T, TT):
            tstart = t0 - span // 2
            xs = np.full(rows * RS, UNWRITTEN, np.int64)
            idx = np.arange((C // 4) * rows)
            cg, r = idx // rows, idx % rows
            t = tstart + r
            inside = (t >= 0) & (t < T)
            for i in range(4):
                v = np.where(inside, x[b, 4 * cg + i, np.clip(t, 0, T - 1)], 0).astype(np.float32)
                if lrelu:
                    v = bf16(np.where(v >= 0, v, v * K_SLOPE))
                qv = np.clip(np.rint(v / s), -127, 127)
                xs[r * RS + 4 * cg + i] = np.where(inside, qv, 0)
            acc = np.zeros((8, 4, 4, 32, 4), np.int64)       # warp, im, in, lane, reg
            for j in range(K):
                ws = np.full(C * RS, UNWRITTEN, np.int64)
                co, ci = np.meshgrid(np.arange(C), np.arange(C), indexing="ij")
                ws[co * RS + ci] = w_q[j, co, ci]
                for warp in range(8):
                    wm, wn = warp % WM, warp // WM
                    a_row = (wm * 64 + G) * RS + 4 * Q
                    b_row = (wn * 32 + G) * RS + 4 * Q + j * dil * RS
                    for kk in range(0, C, 32):
                        A, Bm = [], []
                        for im in range(4):
                            p = a_row + im * 16 * RS + kk
                            regs = [p, p + 8 * RS, p + 16, p + 8 * RS + 16]
                            a = np.zeros((16, 32), np.int64)
                            for reg, (ro, co_off) in zip(regs, ((0, 0), (8, 0), (0, 16), (8, 16))):
                                assert_banks_distinct(reg)
                                for i in range(4):
                                    a[G + ro, co_off + 4 * Q + i] = ws[reg + i]
                            A.append(a)
                        for in_ in range(4):
                            p = b_row + in_ * 8 * RS + kk
                            bm = np.zeros((32, 8), np.int64)
                            for reg, ko in ((p, 0), (p + 16, 16)):
                                assert_banks_distinct(reg)
                                for i in range(4):
                                    bm[ko + 4 * Q + i, G] = xs[reg + i]
                            Bm.append(bm)
                        for im in range(4):
                            for in_ in range(4):
                                assert (A[im] != UNWRITTEN).all() and (Bm[in_] != UNWRITTEN).all()
                                d = A[im] @ Bm[in_]
                                acc[warp, im, in_] += np.stack(
                                    [d[G, 2 * Q], d[G, 2 * Q + 1], d[G + 8, 2 * Q],
                                     d[G + 8, 2 * Q + 1]], -1)
            for warp in range(8):
                wm, wn = warp % WM, warp // WM
                for im in range(4):
                    for h in range(2):
                        co = (wm * 4 + im) * 16 + G + 8 * h
                        sc = s * w_scale[co]
                        for in_ in range(4):
                            for e in range(2):
                                tt = t0 + (wn * 4 + in_) * 8 + 2 * Q + e
                                ok = tt < T
                                y = acc[warp, im, in_, :, 2 * h + e].astype(np.float32) * sc
                                y = bf16(y + bias[co])
                                if residual is not None:
                                    y = bf16(y + residual[b, co, np.minimum(tt, T - 1)])
                                out[b, co[ok], tt[ok]] = y[ok]
    return out


@pytest.mark.parametrize("C,K,dil,T,lrelu,res", [
    (64, 3, 2, 300, True, False), (64, 11, 5, 257, True, True),
    (128, 7, 3, 140, False, True), (256, 3, 1, 100, True, True)])
def test_kernel_model_matches_plain(C, K, dil, T, lrelu, res):
    """The kernel's tiling, staging, fragment maps and epilogue, bitwise
    against `_conv1d_w8a8_plain` on bf16 inputs; T is ragged against the
    block's columns, so the edges and the halo are covered."""
    rs = np.random.RandomState(C + K)
    x = bf16(rs.randn(2, C, T) * 0.5)
    r = bf16(rs.randn(2, C, T) * 0.3)
    w_q, w_s = tq.quantize_weight(torch.as_tensor(rs.randn(K, C, C) * 0.05, dtype=torch.float32))
    wq_t = w_q.permute(0, 2, 1).contiguous()
    bias = bf16(rs.randn(C) * 0.1)
    xt, rt = torch.as_tensor(x).bfloat16(), torch.as_tensor(r).bfloat16()
    a_s = tq.activation_scale(tq.lrelu(xt) if lrelu else xt).reshape(1)
    ref = tq._conv1d_w8a8_plain(xt, wq_t, w_s, torch.as_tensor(bias).bfloat16(), a_s,
                                dilation=dil, apply_lrelu=lrelu, residual=rt if res else None)
    got = w8a8_kernel_model(x, n(wq_t), n(w_s), bias, float(a_s), K=K, dil=dil, lrelu=lrelu,
                            residual=r if res else None)
    np.testing.assert_array_equal(got, _f32(ref))


# ---------------------------------------------------------------------------
# a numpy model of csrc/conv1d_w8a8_ws.cu
# ---------------------------------------------------------------------------

WS_THREADS = 256
LR, LMID, LHI = LANE & 7, (LANE >> 3) & 1, LANE >> 4   # ldmatrix: row, which matrix


def ws_row_key(C, row):
    row = np.asarray(row)
    return (row & 7) if C >= 128 else ((row >> 1) & 3)


def ws_i8_off(C, row, chunk):
    """Byte offset of 16-byte chunk `chunk` of row `row` in an int8 image
    (weights, window) with rows of C bytes: the XOR swizzle."""
    return np.asarray(row) * C + 16 * (np.asarray(chunk) ^ ws_row_key(C, row))


def ws_xb_key(c):
    return (np.asarray(c) >> 2) & 7


def fma32(a, b, c):
    """RN_f32(a * b + c), exactly: the product is exact in float64, the
    float64 sum's own error comes from TwoSum, and a float64 sum on a
    float32 midpoint is rounded by that error's sign."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64) for v in (a, b, c))
    p = a * b
    sm = p + c
    bb = sm - p
    err = (p - (sm - bb)) + (c - bb)
    r = sm.astype(np.float32)
    other = np.nextafter(r, np.where(sm > r, np.float32(np.inf), np.float32(-np.inf)))
    mid = (r.astype(np.float64) + other.astype(np.float64)) / 2
    tie = (sm == mid) & (sm != r) & (err != 0)
    up = np.maximum(r, other)
    down = np.minimum(r, other)
    return np.where(tie, np.where(err > 0, up, down), r).astype(np.float32)


def ws_div(v, s):
    """The kernel's `div_rn`: v / s from RN(1/s) and two corrections."""
    v, s = np.asarray(v, np.float32), np.float32(s)
    r = np.float32(1) / s
    q0 = (v * r).astype(np.float32)
    q1 = fma32(fma32(-s, q0, v), r, q0)
    return fma32(fma32(-s, q1, v), r, q1)


def ws_quantize(v, s):
    """The kernel's `quantize`: +-127 where |v| >= 128 s, else the rounded
    quotient (NaN: 0, as __float2int_rn), clipped."""
    v, s = np.asarray(v, np.float32), np.float32(s)
    big = np.abs(v) >= np.float32(128) * s
    with np.errstate(over="ignore", invalid="ignore"):
        q = np.where(big, np.copysign(np.float32(127), v), ws_div(np.where(big, 0, v), s))
    return np.clip(np.nan_to_num(np.rint(q), nan=0.0), -127, 127).astype(np.int64)


def _warp_rows(addr, active=None):
    """A block-stride loop's per-unit addresses (unit i on thread i % 256
    in round i // 256) as one row of 32 lanes per warp instruction; -1
    for a lane with no unit or an inactive one."""
    addr = np.asarray(addr, np.int64)
    if active is not None:
        addr = np.where(active, addr, -1)
    full = np.full(-(-len(addr) // WS_THREADS) * WS_THREADS, -1, np.int64)
    full[:len(addr)] = addr
    return full.reshape(-1, 32)


def assert_quarters_distinct(rows):
    """16-byte shared accesses (ld/st.v4, one ldmatrix matrix per 8
    lanes): each group of 8 lanes on distinct 16-byte bank groups."""
    rows = np.asarray(rows, np.int64).reshape(-1, 32)
    act = rows >= 0
    assert (rows[act] % 16 == 0).all()
    units = np.where(act, (rows // 16) % 8, -1 - np.arange(32))
    units = np.sort(units.reshape(-1, 4, 8), axis=-1)
    assert (np.diff(units, axis=-1) != 0).all(), rows


def assert_words_distinct(rows):
    """32-bit shared accesses of one warp instruction: 32 lanes on 32
    distinct banks (inactive lanes -1)."""
    rows = np.asarray(rows, np.int64).reshape(-1, 32)
    act = rows >= 0
    assert (rows[act] % 4 == 0).all()
    banks = np.sort(np.where(act, (rows // 4) % 32, -1 - np.arange(32)), axis=-1)
    assert (np.diff(banks, axis=-1) != 0).all(), rows


def _ldmatrix_x4(image, addr):
    """ldmatrix.x4 .b16: lane l gives the row address of matrix l >> 3,
    row l & 7; register m of lane L holds bytes 4(L & 3)..+3 of row L >> 2
    of matrix m.  addr (..., 32) -> (..., 32 lanes, 4 regs, 4 bytes)."""
    rows = addr[..., 8 * np.arange(4)[None, :] + (LANE >> 2)[:, None]]      # (..., 32, 4)
    idx = rows[..., None] + (4 * (LANE & 3))[:, None, None] + np.arange(4)
    return image[idx]


class _WsBlock:
    """One block's shared memory and copies in flight in `ws_kernel_model`."""

    def __init__(self, model, rank, m0):
        self.m, self.rank, self.m0 = model, rank, m0
        m = model
        self.pending = {"w"}
        self.xb = [np.full(m.CC * m.nchp * 8, np.nan, np.float32) for _ in range(m.NB)]
        self.xb_tag = [None] * m.NB
        self.ot = np.full(m.MB * m.OTP, np.nan, np.float32)
        self.ot_tag = np.full(m.MB * m.OTP, -1)
        # the weights, all taps, once: chunk c of row r at c ^ key(r)
        C, K, MB = m.C, m.K, m.MB
        self.W = np.full(K * MB * C, UNWRITTEN, np.int64)
        i = np.arange(K * MB * C // 16)
        chunk, row, j = i % (C // 16), (i // (C // 16)) % MB, i // (C // 16 * MB)
        dst = j * MB * C + ws_i8_off(C, row, chunk)
        assert len(np.unique(dst)) == len(dst)
        for byte in range(16):
            self.W[dst + byte] = m.wq[j, m0 + row, 16 * chunk + byte]

    def issue(self, name):
        """cp.async into `name`, tracked by its mbarrier; the weights, issued
        first, complete before any later copy's barrier phase."""
        assert name not in self.pending, name
        self.pending.add(name)

    def wait(self, name):
        self.pending.discard(name)
        self.pending.discard("w")

    def ready(self, name):
        assert name not in self.pending, name

    def load_window(self, k, buf):
        m = self.m
        b, t0 = m.tile(k)
        wst = (t0 - m.pad) & ~7
        cb = self.rank * m.CC                 # the window channels this block copies
        if m.aligned:       # 16-byte chunks inside [0, T), along each channel row
            u0 = (max(wst, 0) - wst) // 8
            nu = (min(wst + m.r8, m.T) - wst) // 8 - u0
            i = np.arange(m.CC * nu)
            c, u = i // nu, u0 + i % nu
            d = (c * m.nchp + u) * 8
            for e in range(8):
                self.xb[buf][d + e] = m.x[b, cb + c, wst + 8 * u + e]
            self.issue(f"xb{buf}")
        else:
            i = np.arange(m.CC * m.r8)
            c, r = i // m.r8, i % m.r8
            t = wst + r
            ok = (t >= 0) & (t < m.T)
            self.xb[buf][(c * m.nchp + (r >> 3)) * 8 + (r & 7)] = np.where(
                ok, m.x[b, cb + c, np.clip(t, 0, m.T - 1)], 0)
        self.xb_tag[buf] = k

    def load_residual(self, k):
        m = self.m
        b, t0 = m.tile(k)
        n = min(m.TN, m.T - t0)
        for row in range(m.MB):
            self.ot[row * m.OTP:row * m.OTP + n] = m.residual[b, self.m0 + row, t0:t0 + n]
            self.ot_tag[row * m.OTP:row * m.OTP + n] = k
        if m.aligned:
            self.issue("ot")


def ws_kernel_model(x, w_q, w_scale, bias, a_scale, *, K, dil, lrelu, residual, nblk=3):
    """csrc/conv1d_w8a8_ws.cu on (B, C, T) bf16 values (fp32 numpy): the
    C / MB blocks of a time tile, in clusters of CL that share one int8
    window (each block copying and quantizing C / CL channels of it and
    writing its codes into every window of the cluster; two windows in
    turn), or (CL = 0) with split warps (two windows in turn, four MMA
    warps; run here one phase after the other, which the kernel's
    barriers allow), each with its weights' swizzled image; `nblk` persistent
    clusters, each walking tiles tau = x, x + nblk, ..., with the window
    ring and the residual copied as the kernel issues them (T % 8 == 0:
    16-byte cp.async, each buffer's on its mbarrier, so that a buffer is
    read only once waited for, is not copied into while a copy is in
    flight, and holds the tile it should; otherwise element by element);
    the quantize pass;
    ldmatrix fragments lane by lane at the kernel's swizzled addresses,
    rebuilt into m16n8k32 s8 matrices; the epilogue through the output
    tile, and its stores.  Every 16-byte and 32-bit shared access is
    checked for bank conflicts, every read for bytes the tile never
    wrote, every window byte for one write per tile; each output element
    is written once."""
    m = types.SimpleNamespace(x=x, residual=residual, K=K, wq=np.asarray(w_q, np.int64))
    B, C, T = x.shape
    MB, TN, NB, CL = tq.WS_TILES[(C, K)]
    NW = 4 if CL == 0 else 8           # MMA warps: four with split warps
    MT, NT, OTP, CC = MB // 32, TN // (4 * NW), TN + 8, C // CL if CL > 1 else C
    CLN = max(CL, 1)                    # blocks sharing one int8 window
    lay = tq.ws_layout(C, K, dil)
    r8, nch, nchp = lay["r8"], lay["nch"], lay["nchp"]
    assert lay["total"] <= tq.MAX_SMEM and nchp % 8 == 1
    assert CL <= 1 or (CL == C // MB and CL <= 8 and CC // 4 % 8 == 0)
    pad = (K - 1) * dil // 2
    ntt = -(-T // TN)
    ntiles = B * ntt
    nblk = min(nblk, ntiles)
    m.__dict__.update(C=C, T=T, MB=MB, TN=TN, NB=NB, CC=CC, OTP=OTP, r8=r8, nchp=nchp, pad=pad,
                      aligned=T % 8 == 0)
    s = np.float32(a_scale)
    out = np.full(x.shape, np.nan, np.float32)
    n_written = np.zeros(x.shape, np.int64)
    warp = np.arange(NW)[:, None, None]
    wm, wn = warp % 2, warp // 2
    for cy in range(C // MB // CLN):
        for bx in range(nblk):
            m.tile = lambda k, bx=bx: (divmod(bx + k * nblk, ntt)[0],
                                       divmod(bx + k * nblk, ntt)[1] * TN)
            my = (ntiles - 1 - bx) // nblk + 1
            blocks = [_WsBlock(m, r, (cy * CLN + r) * MB) for r in range(CLN)]
            x8s = [None, None]
            for blk in blocks:
                for i in range(min(NB, my)):
                    blk.load_window(i, i)
                if residual is not None and my > 0:
                    blk.load_residual(0)
                if not m.aligned or CL == 0:    # the weights waited in the prologue
                    blk.wait("w")
            for k in range(my):
                b, t0 = m.tile(k)
                wst = (t0 - pad) & ~7
                off0 = (t0 - pad) - wst
                # ---- quantize: each block's buffer k % NB -> the int8 window,
                # in units of 4 channels x 8 times, chunks outside [0, T) as zeros
                x8 = np.full(r8 * C, UNWRITTEN, np.int64)
                x8_writes = np.zeros(r8 * C, np.int64)
                for blk in blocks:
                    if m.aligned:
                        blk.wait(f"xb{k % NB}")
                    blk.ready(f"xb{k % NB}")
                    assert blk.xb_tag[k % NB] == k
                    src = blk.xb[k % NB]
                    i = np.arange(CC // 4 * nch)
                    g4, u = i % (CC // 4), i // (CC // 4)
                    gg = blk.rank * CC // 4 + g4
                    t = wst + 8 * u
                    live = (t >= 0) & (t < T) if m.aligned else np.ones_like(u, bool)
                    vals = np.zeros((len(i), 4, 8), np.float32)
                    for kk in range(4):
                        pos = (kk + (g4 >> 1)) & 3
                        a16 = (4 * g4 + pos) * nchp + u
                        assert_quarters_distinct(_warp_rows(a16 * 16, live))
                        vals[np.arange(len(i))[live], pos[live]] = src[a16[live, None] * 8
                                                                        + np.arange(8)]
                    assert not np.isnan(vals).any()
                    if lrelu:
                        vals = bf16(np.maximum(vals, vals * K_SLOPE))
                    qv = ws_quantize(vals, s)
                    rows_per_warp = max(1, 32 // (CC // 4))
                    flip = (u & 1) if C == 64 else (u % rows_per_warp) * (8 // rows_per_warp)
                    for e in range(8):
                        ee = e ^ flip
                        d = ws_i8_off(C, 8 * u + ee, gg >> 2) + 4 * (gg & 3)
                        assert_words_distinct(_warp_rows(d))
                        for kk in range(4):
                            x8[d + kk] = qv[np.arange(len(i)), kk, ee]
                            x8_writes[d + kk] += 1
                assert (x8_writes <= 1).all()
                if CL != 1:        # two windows in turn: tile k - 2's MMAs are done
                    assert x8s[k % 2] is None or x8s[k % 2][1] <= k - 2
                    x8s[k % 2] = (x8, k)
                # ---- cluster barrier; then each block's MMAs over all taps and C_in
                for blk in blocks:
                    if k + NB < my:
                        blk.load_window(k + NB, k % NB)
                    blk.ready("w")
                    im = np.arange(MT)[None, :, None]
                    ra = (wm * MT + im) * 16 + LR + 8 * LMID                   # (8, MT, 32)
                    a_x = LHI ^ ws_row_key(C, ra)
                    acc = np.zeros((NW, MT, NT, 16, 8), np.int64)
                    for j in range(K):
                        pp = np.arange(NT // 2)[None, :, None]
                        rb = wn * NT * 8 + pp * 16 + 8 * LHI + LR + off0 + j * dil
                        assert rb.max() < r8
                        b_x = LMID ^ ws_row_key(C, rb)
                        for kc in range(C // 32):
                            a_addr = j * MB * C + ra * C + 16 * ((2 * kc) ^ a_x)
                            b_addr = rb * C + 16 * ((2 * kc) ^ b_x)
                            assert (a_addr == j * MB * C + ws_i8_off(C, ra, 2 * kc + LHI)).all()
                            assert (b_addr == ws_i8_off(C, rb, 2 * kc + LMID)).all()
                            assert_quarters_distinct(a_addr)
                            assert_quarters_distinct(b_addr)
                            fa = _ldmatrix_x4(blk.W, a_addr)                   # (8, MT, 32, 4, 4)
                            fb = _ldmatrix_x4(x8, b_addr)                      # (8, NT/2, 32, 4, 4)
                            assert (fa != UNWRITTEN).all() and (fb != UNWRITTEN).all()
                            A = np.zeros((NW, MT, 16, 32), np.int64)
                            Bm = np.zeros((NW, NT, 32, 8), np.int64)
                            for mm in range(4):  # a_m: rows g + 8(m & 1), bytes 16(m >> 1) + 4q
                                for byte in range(4):
                                    A[:, :, G + 8 * (mm & 1), 16 * (mm >> 1) + 4 * Q + byte] = \
                                        fa[:, :, :, mm, byte]
                            for mm in range(4):  # n-tile 2pp + (m >> 1): b0 (m even) or b1
                                for byte in range(4):
                                    Bm[:, (mm >> 1)::2, 16 * (mm & 1) + 4 * Q + byte, G] = \
                                        fb[:, :, :, mm, byte]
                            acc += np.einsum("wmik,wnkj->wmnij", A, Bm)
                    # ---- epilogue: c0..c3 -> the output tile, residual added there
                    if residual is not None and m.aligned:
                        blk.wait("ot")
                    blk.ready("ot")
                    ot, ot_tag, m0 = blk.ot, blk.ot_tag, blk.m0
                    sc = (s * np.asarray(w_scale, np.float32)[m0:m0 + MB]).astype(np.float32)
                    bc = np.asarray(bias, np.float32)[m0:m0 + MB]
                    for im_ in range(MT):
                        for h in range(2):
                            row = (wm[:, 0] * MT + im_) * 16 + G + 8 * h           # (8, 32)
                            for in_ in range(NT):
                                n0 = (wn[:, 0] * NT + in_) * 8 + 2 * Q
                                assert_words_distinct((row * OTP + n0) * 2)
                                for e in range(2):
                                    c_reg = acc[:, im_, in_, G + 8 * h, 2 * Q + e]  # reg 2h + e
                                    yv = bf16(c_reg.astype(np.float32) * sc[row] + bc[row])
                                    d = row * OTP + n0 + e
                                    if residual is not None:
                                        live_n = t0 + n0 + e < T
                                        assert (ot_tag[d][live_n] == k).all()
                                        yv = bf16(yv + ot[d])
                                    ot[d] = yv
                                    ot_tag[d] = k
                    # ---- the tile leaves: 16-byte stores along T (or elements)
                    n = min(TN, T - t0)
                    if m.aligned:
                        i = np.arange(MB * (TN // 8))
                        row, v = i // (TN // 8), i % (TN // 8)
                        assert_quarters_distinct(_warp_rows((row * OTP + 8 * v) * 2, 8 * v < n))
                    for row in range(MB):
                        d = slice(row * OTP, row * OTP + n)
                        assert (ot_tag[d] == k).all()
                        out[b, m0 + row, t0:t0 + n] = ot[d]
                        n_written[b, m0 + row, t0:t0 + n] += 1
                    if residual is not None and k + 1 < my:
                        blk.load_residual(k + 1)
    assert (n_written == 1).all()
    return out


WS_CASES = [
    # C, K, dil, B, T, lrelu, residual: every width and tap count, T ragged
    # against the tile, below one tile, below the taps' span and 1, the
    # aligned (T % 8 == 0) and the element-wise paths
    (64, 3, 1, 3, 600, True, True),
    (64, 7, 3, 1, 100, False, True),
    (64, 11, 5, 3, 37, True, False),
    (64, 11, 1, 1, 520, False, False),
    (64, 7, 3, 3, 400, True, True),
    (64, 3, 5, 3, 300, True, False),
    (128, 3, 5, 3, 264, True, True),
    (128, 7, 1, 1, 5, True, True),
    (128, 11, 3, 3, 301, False, True),
    (128, 7, 5, 3, 136, True, False),
    (128, 11, 5, 1, 48, True, True),
    (128, 11, 3, 3, 300, True, True),
    (128, 3, 1, 1, 200, False, True),
    (256, 3, 3, 1, 130, True, True),
    (256, 7, 5, 3, 72, True, True),
    (256, 11, 1, 1, 200, False, False),
    (256, 11, 5, 3, 9, True, True),
    (256, 3, 1, 3, 1, True, True),
]


@pytest.mark.parametrize("C,K,dil,B,T,lrelu,res", WS_CASES)
def test_ws_kernel_model_matches_plain(C, K, dil, B, T, lrelu, res):
    """csrc/conv1d_w8a8_ws.cu's layouts, lane maps, tile walk, window
    ring, quantize pass and staged epilogue (`ws_kernel_model`), bitwise
    against `_conv1d_w8a8_plain` on bf16 inputs."""
    rs = np.random.RandomState(C * 7 + K * 3 + dil + T)
    x = bf16(rs.randn(B, C, T) * 0.5)
    r = bf16(rs.randn(B, C, T) * 0.3)
    w_q, w_s = tq.quantize_weight(torch.as_tensor(rs.randn(K, C, C) * 0.05, dtype=torch.float32))
    wq_t = w_q.permute(0, 2, 1).contiguous()
    bias = bf16(rs.randn(C) * 0.1)
    xt, rt = torch.as_tensor(x).bfloat16(), torch.as_tensor(r).bfloat16()
    a_s = tq.activation_scale(tq.lrelu(xt) if lrelu else xt).reshape(1)
    ref = tq._conv1d_w8a8_plain(xt, wq_t, w_s, torch.as_tensor(bias).bfloat16(), a_s,
                                dilation=dil, apply_lrelu=lrelu, residual=rt if res else None)
    got = ws_kernel_model(x, n(wq_t), n(w_s), bias, float(a_s), K=K, dil=dil, lrelu=lrelu,
                          residual=r if res else None)
    np.testing.assert_array_equal(got, _f32(ref))


@pytest.mark.parametrize("C,K", sorted(tq.WS_TILES))
def test_ws_scale_and_bias_reads_stay_in_bounds(C, K):
    """csrc/conv1d_w8a8_ws.cu's per-thread reads of w_scale and bias, at
    every thread of every block row of its tiles, warp roles included: a
    split block's quantize warps (0-3) have a negative MMA warp index and
    read neither, and every channel read lies in [0, C) (a read before the
    tensors faulted on the card where they began an allocation)."""
    MB, TN, NB, CL = tq.WS_TILES[(C, K)]
    split, kwm, mt = np.bool_(CL == 0), 2, MB // 32
    tid = np.arange(256)
    warp, g = tid // 32, (tid % 32) // 4
    q_role = ~split | (warp < 4)
    mwarp = np.where(split, warp - 4, warp)
    wm = np.fmod(mwarp, kwm)                     # C's remainder: negative for mwarp < 0
    reads = ~split | ~q_role
    assert reads.sum() == (128 if split else 256)
    for m0 in range(0, C, MB):
        for im in range(mt):
            for h in range(2):
                co = m0 + (wm * mt + im) * 16 + g + 8 * h
                assert ((co[reads] >= 0) & (co[reads] < C)).all()
                assert ((co[reads] >= m0) & (co[reads] < m0 + MB)).all()
                if split:   # what the quantize warps would have read
                    assert (co[~reads] < m0).any()


def test_ws_division_is_correctly_rounded():
    """The kernel's branch-free division (`div_rn`, with its FMAs
    emulated exactly) is IEEE v / s bit for bit, and its quantizer the
    plain version's clip(round(v / s)), on bf16 inputs over many scales:
    random, powers of two, all-ones significands, the calibration floor
    1e-8 / 127; and quotients at and a few ulps around every half-integer
    up to 127.5, where a wrong last bit would move the code."""
    rs = np.random.RandomState(5)
    scales = np.concatenate([
        np.float32(10.0) ** rs.uniform(-6, 1, 40), np.float32(2.0) ** np.arange(-12, 4),
        np.float32([1.9999999, 1.5 - 2 ** -23, 0.99999994, 1e-8 / 127, 3.0 / 127]),
    ]).astype(np.float32)
    half = (np.arange(-128, 128) + 0.5).astype(np.float32)
    for sc in scales:
        v = bf16(np.concatenate([rs.randn(3000) * 60 * sc, rs.uniform(-130, 130, 3000) * sc,
                                 half * sc]))
        ulps = np.arange(-3, 4)[:, None].astype(np.int32)
        near = (half * sc).astype(np.float32).view(np.int32)[None, :] + ulps
        v = np.concatenate([v, near.ravel().view(np.float32), [0.0, -0.0]]).astype(np.float32)
        ok = np.abs(v) < 128 * sc
        # equal values (a zero's sign aside, which the rounding drops)
        np.testing.assert_array_equal(ws_div(v[ok], sc), (v[ok] / sc).astype(np.float32))
        ref = torch.clamp(torch.round(torch.as_tensor(v) / torch.tensor(sc)), -127, 127)
        np.testing.assert_array_equal(ws_quantize(v, sc), ref.numpy().astype(np.int64))
    # beyond the clip, infinities and NaN as __float2int_rn: +-127, 0
    v = np.float32([1e30, -1e30, np.inf, -np.inf, np.nan, 3e38])
    np.testing.assert_array_equal(ws_quantize(v, np.float32(1e-6)), [127, -127, 127, -127, 0, 127])


def _decode_sites(cfg):
    """(C, K, dil) of every int8 decode conv of a config: the stages at C
    >= DECODE_MIN_C, conv1 at each dilation, conv2 at 1."""
    out, c = set(), cfg.upsample_initial_channel
    for _ in cfg.upsample_rates:
        c //= 2
        if c >= tq.DECODE_MIN_C:
            for k, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                out |= {(c, k, d) for d in dils} | {(c, k, 1)}
    return out


@pytest.mark.parametrize("version,sr", [("v2", 48000), ("v2", 40000), ("v1", 32000)])
def test_ws_smem_fits_every_decode_conv(version, sr):
    """The mirror of csrc/conv1d_w8a8_ws.cu's shared-memory layout, at
    every (C, K, dil) the preset's int8 decode runs, is within a block's
    232,448 bytes, and its parts do not overlap."""
    from rvc_maker_tpu_torch.config import preset

    sites = _decode_sites(preset(version, sr).model)
    assert {c for c, _, _ in sites} == set(tq.SUPPORTED_C)
    for c, k, d in sorted(sites):
        lay = tq.ws_layout(c, k, d)
        mb, tn, nb, cl = tq.WS_TILES[(c, k)]
        assert cl in (0, 1, c // mb)
        assert lay["x8"] == mb * c * k
        assert lay["xb"] == lay["x8"] + (2 if cl != 1 else 1) * lay["r8"] * c
        assert lay["ot"] == lay["xb"] + nb * c // max(cl, 1) * lay["nchp"] * 16
        assert lay["bar"] == lay["ot"] + mb * (tn + 8) * 2
        assert lay["total"] == lay["bar"] + 8 * (nb + 1)
        assert lay["r8"] >= tn + (k - 1) * d + 7 and lay["nchp"] % 8 == 1
        assert lay["nchp"] >= lay["nch"] == lay["r8"] // 8
        assert tq.ws_smem_bytes(c, k, d) == lay["total"] <= tq.MAX_SMEM == 232448, (c, k, d)


# ---------------------------------------------------------------------------
# the decode
# ---------------------------------------------------------------------------

def _decode_inputs(cfg, seed=1, b=2, t=40):
    rs = np.random.RandomState(seed)
    return dict(z=bf16(rs.randn(b, t, cfg.inter_channels) * 0.5),
                f0=(rs.rand(b, t) * 300 + 80).astype(np.float32),
                g=bf16(rs.randn(b, 1, cfg.gin_channels)),
                noise=bf16(rs.randn(b, t * cfg.upp, 1)))


def _jax_dec(trees):
    dec = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, trees["synth"]["dec"])
    return jq.prequantize_decode({"dec": dec})["dec"]


def _port_dec(trees, cfg=CFG):
    dec = cast_floats(from_jax.synthesizer_from_jax(tree_np(trees["synth"]), cfg)["dec"],
                      torch.bfloat16)
    return tq.prequantize_decode({"dec": dec})["dec"]


def _jax_decode(dec, inp, use_int8):
    bf = jnp.bfloat16
    out = jax_syn.generator_nsf(dec, JCFG, jnp.asarray(inp["z"], bf), jnp.asarray(inp["f0"]),
                                jnp.asarray(inp["g"], bf), jnp.asarray(inp["noise"], bf),
                                use_int8=use_int8)
    return _f32(out)


def _port_decode(dec, inp, use_int8, cfg=CFG):
    with torch.inference_mode():
        bf = torch.bfloat16
        out = syn.generator_nsf(dec, cfg, torch.as_tensor(inp["z"]).to(bf),
                                torch.as_tensor(inp["f0"]), torch.as_tensor(inp["g"]).to(bf),
                                torch.as_tensor(inp["noise"]).to(bf), use_int8=use_int8)
    return _f32(out)


@pytest.fixture(scope="module")
def jax_calibrated(trees):
    """JAX's calibrated site scales on the decode inputs (a calibrate-mode
    pass), and its static decode at them."""
    import os

    saved = os.environ.get("RVC_TPU_INT8")
    os.environ["RVC_TPU_INT8"] = "1"
    try:
        dec, inp = _jax_dec(trees), _decode_inputs(CFG)
        ctx = jq.Int8Ctx("calibrate")
        _jax_decode(dec, inp, ctx)
        scales, sigs = jq.calibration_scales(ctx.collected, ctx.collected_sigs)
        static = _jax_decode(dec, inp, jq.Int8Ctx("static", scales, sigs))
    finally:
        if saved is None:
            del os.environ["RVC_TPU_INT8"]
        else:
            os.environ["RVC_TPU_INT8"] = saved
    return scales, sigs, static


def test_int8_decode_matches_jax_at_jax_scales(trees, jax_calibrated, monkeypatch):
    """The port's NSF decode with JAX's static scales and signatures,
    JAX's inputs and noise: corr > 0.99 against JAX's."""
    monkeypatch.setenv("RVC_TPU_INT8", "1")
    scales, sigs, ref = jax_calibrated
    assert len(sigs) == N_SITES
    ctx = tq.Int8Ctx("static", scales, sigs)
    got = _port_decode(_port_dec(trees), _decode_inputs(CFG), ctx)
    corr, rel = _corr(got, ref), _rel(got, ref)
    print(f"\nint8 decode port vs JAX at JAX's scales: corr {corr:.6f}, rel {rel:.3e}")
    assert np.isfinite(got).all() and corr > 0.99, corr


def test_plain_decoder_int8_matches_jax(monkeypatch):
    """An f0-less model's plain decoder in int8 with dynamic scales
    (use_int8=True) against JAX's: corr > 0.99."""
    monkeypatch.setenv("RVC_TPU_INT8", "1")
    jcfg = dataclasses.replace(JCFG, use_f0=False)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    tree = jax_syn.init_params(jax.random.PRNGKey(3), jcfg)
    inp = _decode_inputs(cfg, seed=4)
    dec = _jax_dec({"synth": tree})
    ref = _f32(jax_syn.generator(dec, jcfg, jnp.asarray(inp["z"], jnp.bfloat16),
                                 jnp.asarray(inp["g"], jnp.bfloat16), use_int8=True))
    pdec = _port_dec({"synth": tree}, cfg)
    with torch.inference_mode():
        got = _f32(syn.generator(pdec, cfg, torch.as_tensor(inp["z"]).bfloat16(),
                                 torch.as_tensor(inp["g"]).bfloat16(), use_int8=True))
    corr = _corr(got, ref)
    print(f"\nf0-less int8 decode port vs JAX: corr {corr:.6f}")
    assert corr > 0.99, corr


@pytest.mark.parametrize("package", ["jax", "port"])
def test_int8_decode_close_to_bf16(trees, monkeypatch, package):
    """Each package's int8 decode (dynamic scales) against its own bf16
    decode: JAX's quality gate, corr > 0.98 and relative L2 < 0.2."""
    monkeypatch.setenv("RVC_TPU_INT8", "1")
    inp = _decode_inputs(CFG)
    if package == "jax":
        dec = _jax_dec(trees)
        got, ref = _jax_decode(dec, inp, True), _jax_decode(dec, inp, False)
    else:
        dec = _port_dec(trees)
        got, ref = _port_decode(dec, inp, True), _port_decode(dec, inp, False)
    corr, rel = _corr(got, ref), _rel(got, ref)
    print(f"\n{package} int8 vs its bf16 decode: corr {corr:.6f}, rel {rel:.4f}")
    assert np.abs(got - ref).max() > 0                  # int8 engaged
    assert corr > CORR_GATE and rel < REL_GATE, (corr, rel)


def test_int8_decode_launch_route(trees, monkeypatch):
    """Every site at C >= 64 goes through conv1d_w8a8 (16 here), the
    C = 32 stage through fused_resblock; with the flag off none does."""
    calls = []
    orig = tq.conv1d_w8a8
    monkeypatch.setattr(tq, "conv1d_w8a8", lambda x, *a, **k: calls.append(x.shape[1])
                        or orig(x, *a, **k))
    dec, inp = _port_dec(trees), _decode_inputs(CFG)
    monkeypatch.delenv("RVC_TPU_INT8", raising=False)
    _port_decode(dec, inp, True)
    assert calls == []
    monkeypatch.setenv("RVC_TPU_INT8", "1")
    _port_decode(dec, inp, True)
    assert sorted(set(calls)) == [64, 128] and len(calls) == N_SITES


# ---------------------------------------------------------------------------
# HuBERT and RMVPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_hubert_int8_matches_jax(trees, dtype):
    """Features with the six matmuls per layer in W8A8 (per-token scales)
    against JAX's: corr > 0.995."""
    rs = np.random.RandomState(5)
    audio = (rs.randn(2, 16000) * 0.1).astype(np.float32)
    jp = jq.prequantize_hubert(trees["hubert"])
    tp = from_jax.hubert_from_jax(tree_np(trees["hubert"]))
    if dtype == "bf16":
        from rvc_maker_tpu.ops.nn import cast_floats as jax_cast

        jp = jq.prequantize_hubert(jax_cast(trees["hubert"], jnp.bfloat16))
        tp = cast_floats(tp, torch.bfloat16)
    tp = tq.prequantize_hubert(tp)
    aj, at = _pair(audio, dtype)
    ref, _ = jax_hubert.extract_features(jp, aj, output_layer=2, use_int8=True)
    with torch.inference_mode():
        got, _ = hubert_mod.extract_features(tp, at, output_layer=2, use_int8=True)
    corr = _corr(_f32(got), _f32(ref))
    print(f"\nHuBERT int8 {dtype} port vs JAX: corr {corr:.6f}, rel {_rel(_f32(got), _f32(ref)):.3e}")
    assert corr > 0.995, corr


def test_rmvpe_int8_salience_as_close_as_jax(trees):
    """RMVPE's salience net in bf16 with its deep convs in int8: the port's
    distance from its bf16 salience is no more than 1.5x JAX's from JAX's
    (the net's bf16 rounding differs between the frameworks); the int8
    saliences' distance is printed."""
    from rvc_maker_tpu.models import rmvpe as jax_rmvpe
    from rvc_maker_tpu.ops.nn import cast_floats as jax_cast

    tt = np.arange(32000) / 16000
    audio = (0.3 * np.sin(2 * np.pi * 220 * tt)).astype(np.float32)[None]
    mel = jax_rmvpe.rmvpe_mel(jnp.asarray(audio))
    nf = mel.shape[-1]
    mel = jnp.pad(mel, ((0, 0), (0, 0), (0, 32 * ((nf - 1) // 32 + 1) - nf)), mode="reflect")
    jp = jax_cast(jax.tree_util.tree_map(jnp.asarray, trees["rmvpe"]), jnp.bfloat16)
    jpq = jq.prequantize_rmvpe(jp)
    tp = cast_floats(from_jax.rmvpe_from_jax(trees["rmvpe"]), torch.bfloat16)
    tpq = tq.prequantize_rmvpe(tp)
    assert any("w_q" in bp["conv2"] for lp in tpq["intermediate"] for bp in lp["blocks"])
    sal = {}
    for name, p, q, i8 in (("bf16", jp, tp, False), ("int8", jpq, tpq, True)):
        ref = _f32(jax_rmvpe.e2e_apply(p, mel.astype(jnp.bfloat16), use_int8=i8)[:, :nf])
        with torch.inference_mode():
            _, got = rmvpe_mod.infer(q, torch.as_tensor(audio), return_salience=True,
                                     use_int8=i8)
        sal[name] = (ref, n(got))
    jax_drift = float(np.abs(sal["int8"][0] - sal["bf16"][0]).max())
    port_drift = float(np.abs(sal["int8"][1] - sal["bf16"][1]).max())
    print(f"\nRMVPE salience int8 vs bf16: JAX {jax_drift:.3e}, port {port_drift:.3e}; "
          f"port vs JAX in int8 {np.abs(sal['int8'][0] - sal['int8'][1]).max():.3e}")
    assert 0 < port_drift <= 1.5 * jax_drift, (port_drift, jax_drift)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def _jax_pipe(trees, dtype=jnp.bfloat16, **kw):
    return JaxPipeline(trees["synth"], JCFG, trees["hubert"], version="v2",
                       compute_dtype=dtype, **kw)


def _calib_noise(b, p_len):
    """The noise of JAX's calibration pass: PRNGKey(0), bf16 draws."""
    z, sine = jax_noise(b, p_len, CFG.inter_channels, CFG.upp, dtype=jnp.bfloat16)
    return z, {"sine": sine}


def _port_pipe(trees, dtype=torch.bfloat16, **kw):
    return ConvertPipeline(from_jax.synthesizer_from_jax(tree_np(trees["synth"]), CFG), CFG,
                           from_jax.hubert_from_jax(tree_np(trees["hubert"])), version="v2",
                           device="cpu", compute_dtype=dtype, int8_noise_fn=_calib_noise, **kw)


@pytest.fixture(scope="module")
def int8_pipes(trees):
    mp = pytest.MonkeyPatch()
    mp.setenv("RVC_TPU_INT8", "1")
    mp.delenv("RVC_TPU_INT8_SCOPE", raising=False)
    mp.delenv("RVC_TPU_INT8_DYNAMIC", raising=False)
    pipes = {"jax": _jax_pipe(trees), "port": _port_pipe(trees)}
    yield pipes
    mp.undo()


def test_calibrated_scales_match_jax(int8_pipes):
    """Construction calibrates: the same 16 signatures and each site's
    scale within 2e-2 relative of JAX's, on JAX's calibration noise."""
    jctx, pctx = int8_pipes["jax"].use_int8, int8_pipes["port"].use_int8
    assert pctx.mode == jctx.mode == "static"
    assert [tuple(s) for s in pctx.sigs] == [tuple(s) for s in jctx.sigs]
    assert len(pctx.sigs) == N_SITES
    ref, got = np.asarray(jctx.scales), n(pctx.scales)
    assert pctx.scales.dtype == torch.float32 and (got > 0).all()
    worst = float(np.max(np.abs(got - ref) / ref))
    print(f"\ncalibrated scales, port vs JAX: max relative {worst:.3e} over {len(ref)} sites")
    assert worst <= 2e-2, worst


def test_convert_batch_int8_matches_jax(int8_pipes):
    """`convert_batch` with RVC_TPU_INT8=1 in both packages, the port fed
    JAX's noise: corr > 0.98."""
    t = np.arange(16000) / 16000
    audio = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)[None]
    knobs = dict(f0_method="yin", index_rate=0.0, deterministic=True)
    wav_j, _ = int8_pipes["jax"].convert_batch(audio, np.asarray([16000]), 0, JaxSettings(**knobs))
    port = int8_pipes["port"]
    z, noise = _calib_noise(1, port.frames(16000))
    wav, _ = port.convert_batch(audio, [16000], 0, ConvertSettings(**knobs), z_noise=z,
                                noise=noise)
    a, b = n(wav)[0], np.asarray(wav_j, np.float32)[0]
    corr = _corr(a, b)
    print(f"\nconvert_batch int8 port vs JAX: corr {corr:.6f}, max abs {np.abs(a - b).max():.3e}")
    assert np.isfinite(a).all() and corr > CORR_GATE, corr


def test_pipeline_threads_int8_and_fp32_ignores_it(trees, monkeypatch):
    """bf16 with the flag: prequantized weights, static scales, the three
    stage flags; the scope splits them; fp32 ignores the flag."""
    monkeypatch.setenv("RVC_TPU_INT8", "1")
    rm = from_jax.rmvpe_from_jax(trees["rmvpe"])
    pipe = _port_pipe(trees, rmvpe_params=rm)
    assert pipe.use_int8.mode == "static" and pipe.use_int8_hubert and pipe.use_int8_rmvpe
    rb0 = pipe.synth_params["dec"]["resblocks"][0]
    assert rb0["w1_q"].dtype == torch.int8 and rb0["w1_q"].shape == rb0["w1"].shape
    assert pipe.hubert_params["layers"][0]["fc1"]["w_q"].dtype == torch.int8
    monkeypatch.setenv("RVC_TPU_INT8_SCOPE", "hubert")
    scoped = _port_pipe(trees)
    assert scoped.use_int8 is False and scoped.use_int8_hubert and not scoped.use_int8_rmvpe
    assert "w1_q" not in scoped.synth_params["dec"]["resblocks"][0]
    monkeypatch.delenv("RVC_TPU_INT8_SCOPE")
    monkeypatch.setenv("RVC_TPU_INT8_DYNAMIC", "1")
    assert _port_pipe(trees).use_int8 is True          # no calibration
    monkeypatch.delenv("RVC_TPU_INT8_DYNAMIC")
    fp32 = _port_pipe(trees, dtype=None, rmvpe_params=rm)
    assert fp32.use_int8 is False and not fp32.use_int8_hubert and not fp32.use_int8_rmvpe
    assert "w1_q" not in fp32.synth_params["dec"]["resblocks"][0]
    assert "w_q" not in fp32.hubert_params["layers"][0]["fc1"]


def test_int8_scales_stay_fp32_through_the_bf16_cast(trees, monkeypatch):
    """The weights are quantized after the bf16 cast: every w_scale and
    the calibrated scales stay fp32 while the weights are bf16 (JAX
    test_int8_rmvpe_scales_stay_f32_through_prep)."""
    monkeypatch.setenv("RVC_TPU_INT8", "1")
    pipe = _port_pipe(trees, rmvpe_params=from_jax.rmvpe_from_jax(trees["rmvpe"]))
    rb0 = pipe.synth_params["dec"]["resblocks"][0]
    assert rb0["w1"].dtype == torch.bfloat16 and rb0["w1_scale"].dtype == torch.float32
    fc1 = pipe.hubert_params["layers"][0]["fc1"]
    assert fc1["w"].dtype == torch.bfloat16 and fc1["w_scale"].dtype == torch.float32
    convs = [bp[c] for lp in pipe.rmvpe_params["intermediate"] for bp in lp["blocks"]
             for c in ("conv1", "conv2") if "w_q" in bp[c]]
    assert convs and all(c["w_scale"].dtype == torch.float32 and c["w"].dtype == torch.bfloat16
                         for c in convs)
    small = pipe.rmvpe_params["encoder"][0]["blocks"][0]["conv1"]
    assert "w_q" not in small and pipe.use_int8.scales.dtype == torch.float32


def test_int8_gate_respects_dtype_and_env(monkeypatch):
    monkeypatch.delenv("RVC_TPU_INT8", raising=False)
    assert not tq.int8_enabled(torch.bfloat16)
    monkeypatch.setenv("RVC_TPU_INT8", "1")
    assert tq.int8_enabled(torch.bfloat16)
    assert not tq.int8_enabled(torch.float32) and not tq.int8_enabled(None)


def test_int8_scope_warns_on_unknown_token(monkeypatch, caplog):
    monkeypatch.setenv("RVC_TPU_INT8_SCOPE", "rvmpe,decode")
    with caplog.at_level(logging.WARNING):
        scope = tq.int8_scope()
    assert "decode" in scope and any("rvmpe" in r.message for r in caplog.records)
    caplog.clear()
    monkeypatch.setenv("RVC_TPU_INT8_SCOPE", "decode,hubert")
    with caplog.at_level(logging.WARNING):
        assert tq.int8_scope() == frozenset({"decode", "hubert"})
    assert not caplog.records


def test_int8_never_reaches_training():
    """No training module names use_int8, and the training forward takes
    none: the rounding has zero gradient (JAX
    test_int8_never_reaches_training)."""
    from rvc_maker_tpu_torch.pipelines import train, train_loop

    for mod in (train, train_loop):
        assert "use_int8" not in inspect.getsource(mod), mod
    assert "use_int8" not in inspect.signature(syn.train_forward).parameters
    assert inspect.signature(syn.generator_nsf).parameters["use_int8"].default is False


def test_int8_audit_flags_hot_input(trees, monkeypatch, caplog):
    """audit_int8_scales: finite ratios above 0 per site on quiet audio, a
    warning on audio far hotter than calibration, the static context
    kept; RVC_TPU_INT8_AUDIT=1 audits the first utterance."""
    monkeypatch.setenv("RVC_TPU_INT8", "1")
    pipe = _port_pipe(trees)
    baked = pipe.use_int8
    t = np.arange(16000) / 16000
    quiet = (0.05 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    ratio = pipe.audit_int8_scales(quiet)
    assert ratio.shape == (N_SITES,) and np.isfinite(ratio).all() and (ratio > 0).all()
    assert pipe.use_int8 is baked
    loud = np.clip(np.random.RandomState(0).randn(32000) * 8.0, -20, 20).astype(np.float32)
    with caplog.at_level(logging.WARNING, logger="rvc_maker_tpu_torch.pipelines.convert"):
        assert (pipe.audit_int8_scales(loud) > 1.0).any()
    assert any("int8 audit" in r.message for r in caplog.records)
    monkeypatch.setenv("RVC_TPU_INT8_AUDIT", "1")
    pipe.convert_utterance(quiet, 0, ConvertSettings(f0_method="yin", deterministic=True))
    assert pipe._int8_audited


def test_calibration_site_mismatch_falls_back_to_dynamic(trees, monkeypatch, caplog):
    """The signature check's ValueError during calibration leaves dynamic
    scales and a warning (JAX convert.py:208-219)."""
    monkeypatch.setenv("RVC_TPU_INT8", "1")

    def divergent(self, audio):
        ctx = tq.Int8Ctx("static", [1.0], [(3, 64, 64, 9)])
        ctx.reset_sites()
        w_q = torch.zeros((3, 64, 64), dtype=torch.int8)
        ctx.conv(torch.zeros((1, 64, 8)), w_q, torch.ones(64), None, dilation=1)

    monkeypatch.setattr(ConvertPipeline, "_int8_scale_pass", divergent)
    with caplog.at_level(logging.WARNING, logger="rvc_maker_tpu_torch.pipelines.convert"):
        pipe = _port_pipe(trees)
    assert isinstance(pipe.use_int8, tq.Int8Ctx) and pipe.use_int8.mode == "dynamic"
    assert any("int8 calibration failed" in r.message for r in caplog.records)
    with pytest.raises(ValueError, match="int8 site 0 signature"):
        divergent(pipe, None)


def _kernel_route_fails(monkeypatch):
    """Point conv1d_w8a8 at the kernel (as a CUDA tensor would be) whose
    build fails here (no nvcc); record any call of the plain version."""
    plain = []
    monkeypatch.setattr(tq, "_on_card", lambda x: True)
    monkeypatch.setattr(tq.build, "load", lambda name: (_ for _ in ()).throw(
        RuntimeError(f"nvcc not found: cannot build {name}")))
    orig = tq._conv1d_w8a8_plain
    monkeypatch.setattr(tq, "_conv1d_w8a8_plain", lambda *a, **k: plain.append(1) or orig(*a, **k))
    return plain


def test_kernel_error_during_calibration_propagates(trees, monkeypatch):
    """A kernel's build error during calibration reaches the caller: no
    fallback to dynamic scales and no plain version in its place."""
    monkeypatch.setenv("RVC_TPU_INT8", "1")
    plain = _kernel_route_fails(monkeypatch)
    with pytest.raises(RuntimeError, match="nvcc not found: cannot build conv1d_w8a8"):
        _port_pipe(trees)
    assert plain == []


def test_card_tensor_launches_or_raises(monkeypatch):
    """On the kernel's route conv1d_w8a8 checks what the kernel takes
    (bf16, its widths) before building, and a failed build raises."""
    plain = _kernel_route_fails(monkeypatch)
    w_q, w_s = torch.zeros((3, 64, 64), dtype=torch.int8), torch.ones(64)
    b = torch.zeros(64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16"):
        tq.conv1d_w8a8(torch.zeros((1, 64, 8)), w_q, w_s, b)
    with pytest.raises(ValueError, match="C in"):
        tq.conv1d_w8a8(torch.zeros((1, 32, 8), dtype=torch.bfloat16), w_q[:, :32, :32],
                       w_s[:32], b[:32])
    with pytest.raises(RuntimeError, match="nvcc"):
        tq.conv1d_w8a8(torch.zeros((1, 64, 8), dtype=torch.bfloat16), w_q, w_s, b)
    assert plain == []


def test_served_divergent_int8_trace_answers_500(trees, tmp_path, monkeypatch):
    """The server's bf16 pipeline quantizes under RVC_TPU_INT8=1; a request
    whose decode meets a site unlike the calibrated one (Int8SiteMismatch,
    a ValueError) answers 500, not 400: it is raised in the library."""
    import base64
    import http.client
    import io
    import json
    import threading
    from http.server import ThreadingHTTPServer

    from scipy.io import wavfile

    from rvc_maker_tpu.config import RVCConfig as JaxRVCConfig
    from rvc_maker_tpu.interop.torch_export import export_synthesizer_pth
    from rvc_maker_tpu_torch.app import server as srv
    from torch_port_util import hubert_state_dict

    monkeypatch.setenv("RVC_TPU_INT8", "1")
    model, emb = tmp_path / "voice.pth", tmp_path / "hubert.pt"
    export_synthesizer_pth(trees["synth"], JaxRVCConfig(version="v2", model=JCFG), str(model))
    torch.save({"model": hubert_state_dict(tree_np(trees["hubert"]))}, emb)
    monkeypatch.setattr(srv, "SETTINGS_PATH", str(tmp_path / "settings.json"))
    monkeypatch.setattr(srv, "_SETTINGS", {"precision": "bf16"})
    monkeypatch.setattr(srv, "_STATE", dict(srv._STATE, pipeline=None, pipeline_key=None,
                                            batcher=None, batcher_pipe=None))
    srv.set_device("cpu")
    pipe = srv._get_pipeline(str(model), "", "", str(emb))
    assert pipe.use_int8.mode == "static"
    pipe.use_int8.sigs[0] = (11, 128, 128, 5)
    buf = io.BytesIO()
    tt = np.arange(8000) / 16000
    wavfile.write(buf, 16000, (0.3 * np.sin(2 * np.pi * 200 * tt) * 32767).astype(np.int16))
    req = {"model": str(model), "embedder": str(emb), "f0_method": "yin", "index_rate": 0.0,
           "audio_b64": base64.b64encode(buf.getvalue()).decode()}
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv.Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=600)
        conn.request("POST", "/api/convert", body=json.dumps(req),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read().decode())
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert resp.status == 500 and "int8 site 0 signature" in body["error"], (resp.status, body)
