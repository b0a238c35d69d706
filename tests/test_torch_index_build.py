"""The index build of the port (retrieval/index.py kmeans / build_index /
save_index, retrieval/ivf.py, the faiss writer of retrieval/faiss_io.py)
against the JAX package's, on the CPU.

kmeans: the JAX package draws its initial rows and each iteration's
batch from a PRNG key (index.py kmeans); the test repeats those key
splits and hands the port the same row indices."""

import os

import jax
import numpy as np
import pytest
import torch

from rvc_maker_tpu.retrieval import faiss_io as jfaiss
from rvc_maker_tpu.retrieval import index as jindex
from rvc_maker_tpu.retrieval import ivf as jivf
from rvc_maker_tpu_torch.retrieval import faiss_io as tfaiss
from rvc_maker_tpu_torch.retrieval import index as tindex
from rvc_maker_tpu_torch.retrieval import ivf as tivf
from torch_port_util import n, t, torch_threads  # noqa: F401


def blobs(n_rows: int, dim: int, n_blobs: int, seed: int) -> np.ndarray:
    """Rows around n_blobs centres (unit spread around centres 4 apart)."""
    rs = np.random.RandomState(seed)
    centres = rs.randn(n_blobs, dim) * 4.0
    return (centres[rs.randint(0, n_blobs, n_rows)] + rs.randn(n_rows, dim)).astype(np.float32)


def jax_kmeans_rows(seed: int, n: int, k: int, n_iters: int, batch_size: int):
    """The row indices JAX kmeans draws from PRNGKey(seed): initial
    centroids (k,) and each iteration's batch (n_iters, batch_size)."""
    k0, key = jax.random.split(jax.random.PRNGKey(seed))
    init = jax.random.choice(k0, n, (k,), replace=False)
    keys = jax.random.split(key, n_iters)
    batches = [jax.random.choice(bk, n, (min(batch_size, n),), replace=False) for bk in keys]
    return np.array(init), np.stack([np.asarray(b) for b in batches])


@pytest.mark.parametrize("n_rows,dim,k,batch", [(3000, 16, 24, 512), (1500, 768, 40, 4096)])
def test_kmeans_matches_jax_on_the_same_rows(n_rows, dim, k, batch):
    x = blobs(n_rows, dim, 12, seed=dim)
    n_iters = 6
    ref = np.asarray(jindex.kmeans(jax.random.PRNGKey(3), x, k, n_iters=n_iters,
                                   batch_size=batch))
    init, rows = jax_kmeans_rows(3, n_rows, k, n_iters, batch)
    got = tindex.kmeans(t(x), k, n_iters=n_iters, batch_size=batch, init_idx=init,
                        batch_idx=rows)
    assert got.shape == (k, dim)
    # kmeans centroids: <= 1e-4 abs
    np.testing.assert_allclose(n(got), ref, atol=1e-4, rtol=0)


def test_kmeans_draws_from_its_generator():
    x = t(blobs(800, 8, 5, seed=1))
    a = tindex.kmeans(x, 10, n_iters=4, batch_size=300,
                      generator=torch.Generator().manual_seed(5))
    b = tindex.kmeans(x, 10, n_iters=4, batch_size=300,
                      generator=torch.Generator().manual_seed(5))
    c = tindex.kmeans(x, 10, n_iters=4, batch_size=300,
                      generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()


def test_build_index_below_max_rows_is_the_shuffled_matrix(tmp_path):
    x = blobs(500, 16, 4, seed=2)
    ref = jindex.build_index(x, version="v2", seed=4)
    got = tindex.build_index(x, version="v2", seed=4, device="cpu")
    np.testing.assert_array_equal(got.vectors, ref.vectors)
    assert got.version == "v2"
    # save_index writes the .npz that both packages' load_index read
    path = os.path.join(tmp_path, "i.npz")
    tindex.save_index(got, path)
    for load in (jindex.load_index, tindex.load_index):
        back = load(path)
        np.testing.assert_array_equal(back.vectors, ref.vectors)
        assert back.version == "v2"


def test_build_index_above_max_rows_runs_kmeans():
    x = blobs(3000, 16, 8, seed=3)
    got = tindex.build_index(x, version="v1", max_rows=1000, n_clusters=64, seed=2,
                             device="cpu")
    shuffled = x[np.random.RandomState(2).permutation(3000)]
    want = tindex.kmeans(t(shuffled), 64, generator=torch.Generator().manual_seed(2))
    assert got.vectors.shape == (64, 16) and got.version == "v1"
    np.testing.assert_array_equal(got.vectors, n(want))


def test_write_ivf_flat_is_byte_identical_to_jax(tmp_path):
    rs = np.random.RandomState(0)
    vectors = rs.randn(300, 12).astype(np.float32)
    centroids = rs.randn(9, 12).astype(np.float32)
    assign = rs.randint(0, 9, 300)
    assign[assign == 4] = 5                          # an empty list
    pj, pt = os.path.join(tmp_path, "j.index"), os.path.join(tmp_path, "t.index")
    jfaiss.write_ivf_flat(pj, vectors, centroids, assign)
    tfaiss.write_ivf_flat(pt, vectors, centroids, assign)
    with open(pj, "rb") as f, open(pt, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("n_rows,nlist", [(2000, 16), (60, None), (20, None)])
def test_build_ivf_file_matches_jax(tmp_path, monkeypatch, n_rows, nlist):
    """Given the JAX k-means centroids, the port's file equals JAX's byte
    for byte; both packages read it back to the same vectors.  With its
    own k-means the port writes a file both read back too."""
    x = blobs(n_rows, 24, 6, seed=n_rows)
    assert tivf.reference_nlist(n_rows) == jivf.reference_nlist(n_rows)
    pj, pt = os.path.join(tmp_path, "j.index"), os.path.join(tmp_path, "t.index")
    n_j = jivf.build_ivf_file(x, pj, nlist=nlist, seed=1)
    tivf.build_ivf_file(x, pt, nlist=nlist, seed=1, device="cpu")
    assert jfaiss.read_index(pt).centroids.shape == (n_j, 24)
    np.testing.assert_array_equal(tfaiss.read_index(pt).reconstruct_n(), x)
    centroids = jfaiss.read_index(pj).centroids
    monkeypatch.setattr(tivf, "kmeans", lambda v, k, generator: torch.as_tensor(centroids))
    assert tivf.build_ivf_file(x, pt, nlist=nlist, seed=1, device="cpu") == n_j
    with open(pj, "rb") as f, open(pt, "rb") as g:
        assert f.read() == g.read()
    np.testing.assert_array_equal(jindex.load_index(pt).vectors, x)
    np.testing.assert_array_equal(tindex.load_index(pt).vectors, x)
