"""The port's faiss `.index` reader (retrieval/faiss_io.py) and
`load_index` against the JAX package's, on files written by the JAX
package's `write_ivf_flat`; and `cli convert --index x.index` on the CPU."""

import dataclasses

import numpy as np
import pytest

from rvc_maker_tpu.config import ModelConfig as JaxModelConfig
from rvc_maker_tpu.interop.torch_export import synthesizer_state_dict as jax_state_dict
from rvc_maker_tpu.retrieval.faiss_io import write_ivf_flat
from rvc_maker_tpu.retrieval.index import load_index as jax_load_index
from rvc_maker_tpu_torch.config import ModelConfig
from rvc_maker_tpu_torch.interop import from_jax
from rvc_maker_tpu_torch.retrieval import faiss_io
from rvc_maker_tpu_torch.retrieval.index import load_index
from torch_port_util import run_cli_convert, torch_threads  # noqa: F401


def _write(path, n=500, d=768, nlist=7, seed=0):
    rs = np.random.RandomState(seed)
    vectors = rs.randn(n, d).astype(np.float32)
    centroids = rs.randn(nlist, d).astype(np.float32)
    write_ivf_flat(str(path), vectors, centroids, rs.randint(0, nlist, n), nprobe=3)
    return vectors, centroids


@pytest.mark.parametrize("d,version", [(768, "v2"), (256, "v1")])
def test_load_index_matches_jax(tmp_path, d, version):
    """IVF-Flat lists in random order: the dense matrix comes back in id
    order, equal to the written vectors and to the JAX package's."""
    path = tmp_path / "added_IVF7_Flat.index"
    vectors, _ = _write(path, d=d)
    got, ref = load_index(str(path)), jax_load_index(str(path))
    np.testing.assert_array_equal(got.vectors, ref.vectors)
    np.testing.assert_array_equal(got.vectors, vectors)
    assert got.version == ref.version == version


def test_read_index_fields(tmp_path):
    path = tmp_path / "a.index"
    vectors, centroids = _write(path, n=64, d=16, nlist=4, seed=1)
    idx = faiss_io.read_index(str(path))
    assert (idx.d, idx.ntotal, idx.nprobe, len(idx.ids)) == (16, 64, 3, 4)
    np.testing.assert_array_equal(idx.centroids, centroids)
    np.testing.assert_array_equal(idx.reconstruct_n(), vectors)
    assert faiss_io.read_index(path.read_bytes()).ntotal == 64


@pytest.mark.parametrize("cut", ["truncated", "fourcc"])
def test_read_index_rejects_bad_files(tmp_path, cut):
    path = tmp_path / "a.index"
    _write(path, n=32, d=8, nlist=2)
    data = path.read_bytes()
    data = data[:-5] if cut == "truncated" else b"XXXX" + data[4:]
    with pytest.raises(ValueError):
        faiss_io.read_index(data)


def test_cli_convert_with_faiss_index(tmp_path):
    """`cli convert --index added.index` with an NSF model, as every RVC
    user runs it: the index's vectors reach the pipeline."""
    jcfg = JaxModelConfig(
        spec_channels=129, segment_size=8, inter_channels=32, hidden_channels=32,
        filter_channels=64, n_heads=2, n_layers=1, kernel_size=3,
        resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3, 5),),
        upsample_rates=(4, 4, 2, 2), upsample_initial_channel=32,
        upsample_kernel_sizes=(8, 8, 4, 4), spk_embed_dim=4, gin_channels=16,
        sr=6400, use_f0=True, text_enc_hidden_dim=768)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    tree = from_jax.random_synthesizer_tree(cfg, seed=3)
    _write(tmp_path / "added.index", n=200)
    out, sr = run_cli_convert(
        tmp_path, jax_state_dict(tree, jcfg), jcfg,
        from_jax.random_hubert_tree(seed=1, n_layers=2),
        from_jax.random_rmvpe_tree(seed=2, widths=(4, 8, 16, 32, 64), inter_width=128),
        tmp_path / "added.index", seconds=1.0)
    assert sr == jcfg.sr and abs(len(out) - jcfg.sr) <= 2 * jcfg.upp
    assert np.isfinite(out).all() and np.abs(out).max() > 0
