"""The port's primitives (ops/nn.py, ops/stft.py, f0/common.py) against
the JAX package's, on the same numpy inputs.  Also: the port imports no
JAX and nothing of the JAX package."""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu.f0 import common as jf0
from rvc_maker_tpu.ops import nn as jnn
from rvc_maker_tpu.ops import stft as jstft
from rvc_maker_tpu_torch.f0 import common as tf0
from rvc_maker_tpu_torch.ops import nn as tnn
from rvc_maker_tpu_torch.ops import stft as tstft
from torch_port_util import n, t, torch_threads  # noqa: F401

ATOL = 1e-5
REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("stride,dilation,padding,groups", [
    (1, 1, 3, 1), (1, 3, 3, 1), (2, 1, (1, 2), 1), (5, 1, 0, 1), (1, 1, 4, 4),
])
def test_conv1d(stride, dilation, padding, groups):
    rs = np.random.RandomState(0)
    x = rs.randn(2, 37, 8).astype(np.float32)
    w = rs.randn(7, 8 // groups, 12).astype(np.float32) * 0.3
    b = rs.randn(12).astype(np.float32)
    ref = jnn.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                     dilation=dilation, padding=padding, groups=groups)
    got = tnn.conv1d(t(x).transpose(1, 2), t(w).permute(2, 1, 0), t(b),
                     stride=stride, dilation=dilation, padding=padding,
                     groups=groups).transpose(1, 2)
    np.testing.assert_allclose(n(got), n(ref), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("u,k", [(12, 24), (10, 20), (2, 4), (5, 10), (3, 6)])
def test_conv_transpose1d_stage_paddings(u, k):
    """Even and odd strides with the padding / output_padding that
    _stage_paddings gives (output_padding = u % 2)."""
    convt_pad = ((k - u) // 2) if u % 2 == 0 else (u // 2 + u % 2)
    out_pad = u % 2
    rs = np.random.RandomState(u)
    x = rs.randn(2, 9, 6).astype(np.float32)
    w = rs.randn(k, 6, 4).astype(np.float32) * 0.3      # JAX (K, Cin, Cout)
    b = rs.randn(4).astype(np.float32)
    ref = jnn.conv_transpose1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               stride=u, padding=convt_pad,
                               output_padding=out_pad)
    got = tnn.conv_transpose1d(t(x).transpose(1, 2), t(w).permute(1, 2, 0), t(b),
                               stride=u, padding=convt_pad,
                               output_padding=out_pad).transpose(1, 2)
    assert got.shape[1] == 9 * u
    np.testing.assert_allclose(n(got), n(ref), atol=ATOL, rtol=1e-5)


def test_dense_ops():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 5, 6).astype(np.float32)
    w = rs.randn(6, 3).astype(np.float32)
    b = rs.randn(3).astype(np.float32)
    np.testing.assert_allclose(n(tnn.linear(t(x), t(w.T), t(b))),
                               n(jnn.linear(x, w, b)), atol=ATOL)
    g, be = rs.randn(6).astype(np.float32), rs.randn(6).astype(np.float32)
    np.testing.assert_allclose(n(tnn.layer_norm(t(x), t(g), t(be))),
                               n(jnn.layer_norm(x, g, be)), atol=ATOL)
    table = rs.randn(10, 4).astype(np.float32)
    ids = rs.randint(0, 10, (2, 7))
    np.testing.assert_array_equal(n(tnn.embedding(t(table), torch.as_tensor(ids))),
                                  n(jnn.embedding(table, ids)))
    lengths = np.array([3, 7])
    np.testing.assert_array_equal(
        n(tnn.sequence_mask(torch.as_tensor(lengths), 9)),
        n(jnn.sequence_mask(jnp.asarray(lengths), 9)))
    gx = rs.randn(2, 5, 8).astype(np.float32)
    gg = rs.randn(2, 1, 8).astype(np.float32)
    np.testing.assert_allclose(n(tnn.fused_gate(t(gx), t(gg))),
                               n(jnn.fused_gate(gx, gg)), atol=ATOL)
    np.testing.assert_array_equal(n(tnn.interp_nearest_x2(t(x))),
                                  n(jnn.interp_nearest_x2(x)))
    for slope in (0.1, 0.01):
        np.testing.assert_allclose(n(tnn.leaky_relu(t(x), slope)),
                                   n(jnn.leaky_relu(x, slope)), atol=0)


def test_rmvpe_mel():
    rs = np.random.RandomState(2)
    audio = (rs.randn(2, 8000) * 0.3).astype(np.float32)
    ref = n(jstft.rmvpe_mel(jnp.asarray(audio)))
    got = n(tstft.rmvpe_mel(t(audio)))
    assert got.shape == ref.shape == (2, 128, 51)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(tstft.mel_filterbank(16000, 1024, 128, 30.0, 8000.0, True),
                                  jstft.mel_filterbank(16000, 1024, 128, 30.0, 8000.0, True))


def test_f0_common():
    rs = np.random.RandomState(3)
    f0 = np.concatenate([rs.uniform(40, 1200, 200), [0.0, 0.0]]).astype(np.float32)
    f0 = f0[None]
    np.testing.assert_array_equal(n(tf0.coarse_f0(t(f0))), n(jf0.coarse_f0(jnp.asarray(f0))))
    # coarse_f0 rounds half to even on both sides (torch.round, jnp.rint)
    halves = np.array([0.5, 1.5, 2.5, 100.5, 101.5], np.float32)
    np.testing.assert_array_equal(n(torch.round(t(halves))), n(jnp.rint(halves)))
    np.testing.assert_allclose(n(tf0.shift_f0(t(f0), 3)),
                               n(jf0.shift_f0(jnp.asarray(f0), 3)), rtol=1e-6)
    np.testing.assert_allclose(n(tf0.autotune_f0(t(f0), 0.7)),
                               n(jf0.autotune_f0(jnp.asarray(f0), 0.7)), rtol=1e-6)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _module_level_imports(path: Path):
    """Imports that run when the module is imported: its top-level
    statements, including those under a top-level if / try."""
    stack = list(ast.parse(path.read_text()).body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, (ast.If, ast.Try)):
            stack.extend(node.body + node.orelse + getattr(node, "finalbody", [])
                         + [s for h in getattr(node, "handlers", []) for s in h.body])


@pytest.mark.parametrize("root", ["rvc_maker_tpu_torch", "rvc_maker_tpu_torch/tools",
                                  "chip_smoke.py", "tests/read_aloud_fake.py"])
def test_port_imports_no_jax(root):
    """No JAX and nothing of the JAX package anywhere, nor `safetensors`,
    `transformers` or `diffusers`, which the card's machine lacks (the
    port reads .safetensors files itself, `interop/safetensors_io.py`),
    not even inside a function; and `cryptography`, which it may lack,
    only inside the functions that need it."""
    path = REPO / root
    files = [path] if path.is_file() else sorted(path.rglob("*.py"))
    assert files
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "rvc_maker_tpu", "safetensors", "transformers",
                               "diffusers"), (f, mod)
        for mod in _module_level_imports(f):
            assert mod.split(".")[0] != "cryptography", (f, mod)


@pytest.mark.parametrize("fail", [False, True], ids=["builds", "fails"])
def test_build_all_runs_each_source_and_reports(tmp_path, monkeypatch, fail):
    """build_all starts one compiler per source and records its seconds;
    a failing compiler raises with that source's output; a source built
    before is not built again and its output is read back.  A shell script
    stands in for nvcc (this machine has none): it writes the library
    named after -o, or prints an error and exits 1."""
    from rvc_maker_tpu_torch.ops import build

    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + ('echo "error: $0 refused"; exit 1\n' if fail else
                                     'while [ "$1" != "-o" ]; do shift; done\n'
                                     'echo ptxas report; touch "$2"\n'))
    nvcc.chmod(0o755)
    (tmp_path / "a.cu").write_text("// a")
    (tmp_path / "b.cu").write_text("// b")
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "SOURCES", {"a": "a.cu", "b": "b.cu"})
    monkeypatch.setattr(build, "build_seconds", {})
    if fail:
        with pytest.raises(RuntimeError, match="nvcc exited 1\nerror: .* refused"):
            build.build_all()
        assert not list((tmp_path / "_build").iterdir())
        return
    logs = build.build_all()
    assert logs == {"a": "ptxas report\n", "b": "ptxas report\n"}
    assert set(build.build_seconds) == {"a", "b"}
    assert all(build.library_path(k).exists() for k in ("a", "b"))
    # built: nothing runs, and each earlier build's output is read back
    build.build_seconds.clear()
    assert build.build_all() == logs and not build.build_seconds
    # a library whose output was not kept is built again
    build.log_path("a").unlink()
    assert build.build_all() == logs and set(build.build_seconds) == {"a"}


def _ptxas_log(kernel: str, spill: int = 0) -> str:
    """ptxas -v's lines for the 15 (C, k) instantiations of `kernel`."""
    out = []
    for c in (256, 128, 64, 32, 16):
        for k in (11, 7, 3):
            name = f"_ZN12_GLOBAL__N_1{len(kernel)}{kernel}ILi{c}ELi{k}EEEvPK13__nv_bfloat16ii"
            out += [f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
                    f"ptxas info    : Function properties for {name}",
                    f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads",
                    "ptxas info    : Used 128 registers, used 2 barriers"]
    return "\n".join(out)


@pytest.mark.parametrize("case", ["built", "cached_without_log", "spilled"])
def test_resblock_ptxas_gate(case):
    """chip_smoke.py phase 2's gate on the tensor-core resblock kernels'
    ptxas figures: it passes with all 15 instantiations of each reported
    and no spill, and fails where a source's output is missing (as it was
    for a library built by an earlier run, before build_all kept it) or
    an instantiation spills."""
    import chip_smoke

    logs = {"resblock_tc": _ptxas_log("resblock_tc_step_kernel"),
            "resblock_tc_bf16": _ptxas_log("resblock_tc_bf16_step_kernel")}
    if case == "built":
        rows = chip_smoke.resblock_ptxas_gate(logs)
        assert {src: len(r) for src, r in rows.items()} == {"resblock_tc": 15,
                                                            "resblock_tc_bf16": 15}
        assert rows["resblock_tc_bf16"][0] == dict(C=256, K=11, registers=128,
                                                   spill_stores=0, spill_loads=0)
        return
    if case == "cached_without_log":
        logs["resblock_tc_bf16"] = ""
        match = "'resblock_tc_bf16': 0"
    else:
        logs["resblock_tc"] = _ptxas_log("resblock_tc_step_kernel", spill=8)
        match = r"spills at \[\('resblock_tc', 256, 11\)"
    with pytest.raises(AssertionError, match=match):
        chip_smoke.resblock_ptxas_gate(logs)
