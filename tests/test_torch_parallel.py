"""The port's multi-rank paths (`rvc_maker_tpu_torch/parallel/`, the sharded
train step, the rank-sliced batches, train() across ranks, sharded
conversion) in two gloo ranks on the CPU, against the JAX package's
sharded functions on a 2-device mesh (conftest's host devices) and
against the port's own single process.

One module fixture spawns the two ranks once and runs every rank-side
job (tests/torch_parallel_worker.py, no JAX), computing the JAX
references while they run; the tests compare.  The tolerances are the
JAX tests': the train step's losses rtol 2e-4 (tests/test_train_step.py),
each gradient leaf 1e-3 x its max |g|, conversion rtol 1e-3 / atol 2e-4
(tests/test_mesh_convert.py), the blend rtol 1e-4 / atol 1e-5
(tests/test_sharded_retrieval.py), HuBERT rtol 2e-3 / atol 2e-4
(tests/test_tensor_parallel.py)."""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from rvc_maker_tpu.config import DataConfig, ModelConfig, RVCConfig, TrainConfig
from rvc_maker_tpu.parallel import data_mesh
from rvc_maker_tpu.parallel import replicate as jreplicate
from rvc_maker_tpu.parallel import shard_leading as jshard_leading
from rvc_maker_tpu.parallel.retrieval import shard_index_rows as jshard_index_rows
from rvc_maker_tpu.parallel.retrieval import sharded_retrieval_blend as jsharded_blend
from rvc_maker_tpu.parallel.tensor import shard_hubert_tp as jshard_hubert_tp
from rvc_maker_tpu.parallel.tensor import tp_extract_features as jtp_extract_features
from rvc_maker_tpu.pipelines import data as jdata
from rvc_maker_tpu.pipelines import train as jtrain
from rvc_maker_tpu.pipelines.convert import ConvertPipeline as JaxPipeline
from rvc_maker_tpu.pipelines.convert import ConvertSettings as JaxSettings
from rvc_maker_tpu_torch import config as tconfig
from rvc_maker_tpu_torch.interop import from_jax
from rvc_maker_tpu_torch.models import hubert as thubert
from rvc_maker_tpu_torch.parallel import distributed as dist_mod
from rvc_maker_tpu_torch.parallel import mesh as tmesh
from rvc_maker_tpu_torch.parallel import tensor as ttensor
from rvc_maker_tpu_torch.pipelines import train as ttrain
from rvc_maker_tpu_torch.pipelines import train_loop as tloop
from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline, ConvertSettings
from rvc_maker_tpu_torch.retrieval.index import retrieval_blend
from rvc_maker_tpu_torch.utils.audio import save_wav
from torch_parallel_worker import join_ranks, start_ranks
from torch_port_util import assert_grads_close, jax_noise, n, torch_threads  # noqa: F401

WORLD = 2
HOP, SEG, B, T, DIV = 64, 8, 4, 24, 16
_MODEL = dict(
    spec_channels=129, segment_size=SEG, inter_channels=32, hidden_channels=32,
    filter_channels=64, n_heads=2, n_layers=1, kernel_size=3,
    resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
    upsample_rates=(4, 4, 2, 2), upsample_initial_channel=32,
    upsample_kernel_sizes=(8, 8, 4, 4), spk_embed_dim=4, gin_channels=16, sr=16000,
    use_f0=True, text_enc_hidden_dim=96)
_DATA = dict(sample_rate=16000, filter_length=256, hop_length=HOP, win_length=256,
             n_mel_channels=32)
JCFG = RVCConfig(version="v2", train=TrainConfig(segment_size=SEG * HOP),
                 data=DataConfig(**_DATA), model=ModelConfig(**_MODEL))
TCFG = tconfig.RVCConfig(version="v2", train=tconfig.TrainConfig(segment_size=SEG * HOP),
                         data=tconfig.DataConfig(**_DATA),
                         model=tconfig.ModelConfig(**_MODEL))
# the conversion model of tests/test_mesh_convert.py
_CONVERT_MODEL = dict(
    spec_channels=129, segment_size=8, inter_channels=32, hidden_channels=32,
    filter_channels=64, n_heads=2, n_layers=1, kernel_size=3,
    resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
    upsample_rates=(4, 4, 2, 2), upsample_initial_channel=32,
    upsample_kernel_sizes=(8, 8, 4, 4), spk_embed_dim=4, gin_channels=16,
    sr=6400, use_f0=True, text_enc_hidden_dim=768)
CONVERT_SETTINGS = dict(f0_method="yin", index_rate=0.5, deterministic=True)
N_ITEMS, ITEM_BATCH = 4, 2          # train(): 4 items, 2 rows per rank, 1 step per epoch


def _mesh2():
    return data_mesh(jax.devices()[:WORLD])


def _step_batch():
    """The global batch: rank 0's rows are full length, rank 1's short,
    so the ranks' KL mask sums differ (48 against 30 frames)."""
    rs = np.random.RandomState(3)
    lengths = np.array([T, T, SEG + 1, T - 3], np.int32)
    return dict(
        phone=rs.randn(B, T, 96).astype(np.float32), phone_lengths=lengths,
        pitch=rs.randint(1, 256, (B, T)).astype(np.int32),
        pitchf=(rs.rand(B, T) * 200 + 80).astype(np.float32),
        spec=np.abs(rs.randn(B, T, 129)).astype(np.float32), spec_lengths=lengths,
        wave=(rs.randn(B, T * HOP, 1) * 0.1).astype(np.float32),
        sid=rs.randint(0, 4, (B,)).astype(np.int32))


def _jax_draws(rng, lengths):
    """The noise JAX's step draws from `rng` for the global batch
    (tests/test_torch_train.py)."""
    rng_fwd, _ = jax.random.split(rng)
    k_post, k_slice, k_sine = jax.random.split(rng_fwd, 3)
    m = JCFG.model
    post = jax.random.normal(k_post, (B, T, m.inter_channels), jnp.float32)
    u = jax.random.uniform(k_slice, (B,))
    ids = (u * (jnp.asarray(lengths) - SEG + 1)).astype(jnp.int32)
    sine = jax.random.normal(k_sine, (B, SEG * m.upp, 1), jnp.float32)
    return dict(post_noise=torch.tensor(np.asarray(post)),
                ids_slice=torch.tensor(np.asarray(ids)),
                dec_noise={"sine": torch.tensor(np.asarray(sine))})


def _write_exp(exp: str, rs) -> str:
    """N_ITEMS training items in one length bucket (101-200 frames), each
    with its spectrogram cache, so the port and JAX read the same data."""
    for sub in ("wavs", "feats", "f0", "f0nsf"):
        os.makedirs(os.path.join(exp, sub), exist_ok=True)
    rows = []
    for i in range(N_ITEMS):
        frames = int(rs.randint(110, 190))
        wav = os.path.join(exp, "wavs", f"{i}.wav")
        save_wav(wav, (rs.randn(frames * HOP) * 0.1).astype(np.float32), 16000, "float32")
        np.save(wav.replace(".wav", ".spec.npy"),
                np.abs(rs.randn(frames + 1, 129)).astype(np.float32))
        paths = [os.path.join(exp, d, f"{i}.npy") for d in ("feats", "f0", "f0nsf")]
        np.save(paths[0], rs.randn(frames // 2 + 1, 96).astype(np.float32))
        np.save(paths[1], rs.randint(1, 256, frames).astype(np.int32))
        np.save(paths[2], (rs.rand(frames) * 200 + 80).astype(np.float32))
        rows.append("|".join([wav] + paths + [str(i % 2)]))
    with open(os.path.join(exp, "filelist.txt"), "w") as f:
        f.write("\n".join(rows))
    return os.path.join(exp, "filelist.txt")


def _hubert_tree(seed, n_layers):
    """A random HuBERT tree (JAX layout) with non-zero biases, so that the
    row-parallel layers' bias is seen to be added once."""
    tree = from_jax.random_hubert_tree(seed, n_layers=n_layers)
    rs = np.random.RandomState(seed + 100)
    layers = tree["layers"]
    for lin in [layers["attn"][k] for k in ("q", "k", "v", "o")] + [
            layers["fc1"], layers["fc2"], tree["final_proj"]]:
        lin["b"] = (rs.randn(*lin["b"].shape) * 0.1).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Inputs for every rank-side job, the two ranks' results, and what
    the parent needs to check them."""
    work = str(tmp_path_factory.mktemp("ranks"))
    rs = np.random.RandomState(0)
    jparams_g = from_jax.random_synthesizer_tree(TCFG.model, seed=0)
    jparams_d = from_jax.random_discriminator_tree("v2", DIV, seed=1)
    params_g = from_jax.synthesizer_from_jax(jparams_g, TCFG.model, train=True)
    params_d = from_jax.discriminator_from_jax(jparams_d)
    batch = _step_batch()
    rng = jax.random.PRNGKey(7)
    draws = _jax_draws(rng, batch["spec_lengths"])
    bf16_remat = dataclasses.replace(TCFG, train=dataclasses.replace(
        TCFG.train, bf16=True, remat=True))
    step = dict(params_g=params_g, params_d=params_d, div=DIV, cases=[
        dict(name="jax_noise", cfg=TCFG, batch=batch, noise=draws),
        dict(name="drawn", cfg=TCFG, batch=batch, noise=None),
        dict(name="bf16_remat", cfg=bf16_remat, batch=batch, noise=None)])

    exp = os.path.join(work, "exp")
    filelist = _write_exp(exp, rs)
    exp_a, exp_c = os.path.join(work, "exp_a"), os.path.join(work, "exp_c")
    for d in (exp_a, exp_c):
        os.makedirs(d)
        shutil.copy(filelist, d)
    batches = dict(filelist=filelist, cfg=TCFG, batch_size=WORLD, epoch=1, seed=1234)
    train = dict(cfg=TCFG, batch_size=ITEM_BATCH, div=DIV, exp_a=exp_a, exp_c=exp_c)

    ccfg = tconfig.ModelConfig(**_CONVERT_MODEL)
    synth_j = from_jax.random_synthesizer_tree(ccfg, seed=0)
    hubert_j = from_jax.random_hubert_tree(1, n_layers=2)
    index = rs.randn(128, 768).astype(np.float32)
    tt = np.arange(16000) / 16000
    audio = np.stack([0.3 * np.sin(2 * np.pi * (150 + 20 * i) * tt)
                      for i in range(3)]).astype(np.float32)
    lengths = np.array([16000, 16000, 12000])
    p_len = ConvertPipeline.frames(16000)
    z2, s2 = jax_noise(2, p_len, ccfg.inter_channels, ccfg.upp)
    z4, s4 = jax_noise(4, p_len, ccfg.inter_channels, ccfg.upp)   # JAX pads 3 rows to 4
    convert = dict(
        synth=from_jax.synthesizer_from_jax(synth_j, ccfg), cfg=ccfg,
        hubert=from_jax.hubert_from_jax(hubert_j), index=index, max_device_batch=2,
        settings=CONVERT_SETTINGS, cases=[
            dict(name="even", audio=audio[:2], lengths=lengths[:2], z=z2,
                 noise={"sine": s2}),
            dict(name="odd", audio=audio, lengths=lengths, z=z4[:3], noise={"sine": s4[:3]}),
            dict(name="drawn", audio=audio, lengths=lengths)])

    blend = [dict(feats=rs.randn(2, 7, 32).astype(np.float32),
                  vectors=rs.randn(640, 32).astype(np.float32), rate=0.6, k=8),
             dict(feats=rs.randn(1, 5, 16).astype(np.float32),       # 101 % 2: a pad row
                  vectors=rs.randn(101, 16).astype(np.float32), rate=1.0, k=4)]

    tp = []
    for version, seed, n_samples, lens in (("v2", 1, 8000, [8000, 6400]),
                                          ("v1", 2, 6400, [6400, 6400])):
        tree = _hubert_tree(seed, 2)
        tp.append(dict(version=version, jax_tree=tree, params=from_jax.hubert_from_jax(tree),
                       audio=(rs.randn(2, n_samples) * 0.1).astype(np.float32),
                       lengths=np.array(lens)))

    inputs = dict(step=step, batches=batches, train=train, convert=convert, blend=blend,
                  tp=[{k: v for k, v in c.items() if k != "jax_tree"} for c in tp])
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    ctx = start_ranks(work, WORLD)
    try:
        jax_ref = _jax_references(rng, batch, (synth_j, hubert_j), index, convert["cases"],
                                  blend, tp)
    finally:
        outs = join_ranks(ctx, work)
    return dict(outs=outs, jax=jax_ref, batch=batch, draws=draws, **inputs)


def _jax_references(rng, batch, convert_trees, index, convert_cases, blend, tp):
    """The JAX package's sharded functions on a 2-device mesh: the train
    step's metrics, the mesh conversions, the blends, tensor-parallel
    HuBERT."""
    mesh = _mesh2()
    step = jtrain.make_sharded_train_step(JCFG, mesh, disc_width_div=DIV)
    new_state, m = step(jreplicate(_jax_state(), mesh),
                        jshard_leading(jtrain.Batch(**batch), mesh), jreplicate(rng, mesh))
    # the step's gradients, read back from AdamW's first moment after one
    # step from zero: mu = (1 - b1) g
    b1 = JCFG.train.betas[0]

    def grads(opt_state):
        return jax.tree_util.tree_map(lambda v: np.asarray(v) / (1.0 - b1),
                                      opt_state.inner_state[0].mu)

    out = dict(step={k: float(v) for k, v in m.items()},
               grads_g=ttrain.tree_leaves(from_jax.synthesizer_from_jax(
                   grads(new_state.opt_g), TCFG.model, train=True)),
               grads_d=ttrain.tree_leaves(from_jax.discriminator_from_jax(
                   grads(new_state.opt_d))))

    synth_j, hubert_j = convert_trees
    pipe = JaxPipeline(jax.tree_util.tree_map(jnp.asarray, synth_j),
                       ModelConfig(**_CONVERT_MODEL),
                       jax.tree_util.tree_map(jnp.asarray, hubert_j), version="v2",
                       index_vectors=index, mesh=mesh)
    out["convert"] = {c["name"]: tuple(np.asarray(a) for a in pipe.convert_batch(
        c["audio"], c["lengths"], 0, JaxSettings(**CONVERT_SETTINGS)))
        for c in convert_cases if c["name"] != "drawn"}

    out["blend"] = [np.asarray(jsharded_blend(mesh, k=c["k"])(
        jnp.asarray(c["feats"]), jshard_index_rows(mesh, c["vectors"]),
        jnp.float32(c["rate"]))) for c in blend]

    tp_mesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(1, WORLD), ("data", "model"))
    out["tp"] = {}
    with tp_mesh:
        for c in tp:
            fn = jtp_extract_features(jshard_hubert_tp(
                jax.tree_util.tree_map(jnp.asarray, c["jax_tree"]), tp_mesh), tp_mesh,
                version=c["version"])
            out["tp"][c["version"]] = np.asarray(fn(jnp.asarray(c["audio"]),
                                                    jnp.asarray(c["lengths"])))
    return out


# -- the environment contract ------------------------------------------------

def test_env_contract_parsing():
    assert dist_mod.env_contract({}) is None
    env = dict(RVC_COORDINATOR_ADDRESS="10.0.0.1:1234", RVC_NUM_PROCESSES="4",
               RVC_PROCESS_ID="3")
    assert dist_mod.env_contract(env) == ("tcp://10.0.0.1:1234", 4, 3)
    assert dist_mod.env_contract(dict(env, RVC_COORDINATOR_ADDRESS="file:///tmp/s"))[0] \
        == "file:///tmp/s"
    for bad in (dict(env, RVC_PROCESS_ID="4"), dict(env, RVC_NUM_PROCESSES="x"),
                {"RVC_COORDINATOR_ADDRESS": "h:1"}):
        with pytest.raises(ValueError):
            dist_mod.env_contract(bad)
    with pytest.raises(RuntimeError, match="RVC_COORDINATOR_ADDRESS.*RVC_NUM_PROCESSES"):
        dist_mod.env_contract({"RVC_MULTIHOST": "1"})


def test_single_process_is_a_no_op(monkeypatch):
    for var in dist_mod.ENV_VARS + ("RVC_MULTIHOST",):
        monkeypatch.delenv(var, raising=False)
    assert dist_mod.ensure_initialized("cpu") is False
    assert (dist_mod.process_index(), dist_mod.process_count()) == (0, 1)
    assert dist_mod.is_primary() and dist_mod.local_batch_size(8) == 8
    dist_mod.sync_global()
    assert dist_mod.rank_device("cpu") == torch.device("cpu")
    x = [torch.ones(3)]
    assert tmesh.all_reduce_(x)[0].tolist() == [1.0, 1.0, 1.0]
    monkeypatch.setenv("RVC_MULTIHOST", "1")
    with pytest.raises(RuntimeError, match="RVC_PROCESS_ID"):
        dist_mod.ensure_initialized("cpu")


def test_backend_by_rule_and_missing_card(monkeypatch):
    """NCCL only when every rank has a card; a card asked for but absent
    raises, whatever the rank."""
    assert dist_mod.backend_for("cpu", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert dist_mod.backend_for("cuda", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert dist_mod.backend_for("cuda", 2) == "nccl"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        dist_mod.rank_device("cuda", rank=1)


# -- the train step ----------------------------------------------------------

def _jax_state():
    opt = jtrain.make_optimizer(JCFG)
    pg = jax.tree_util.tree_map(jnp.asarray, from_jax.random_synthesizer_tree(
        TCFG.model, seed=0))
    pd = jax.tree_util.tree_map(jnp.asarray, from_jax.random_discriminator_tree(
        "v2", DIV, seed=1))
    return jtrain.TrainState(step=jnp.zeros((), jnp.int32), params_g=pg, params_d=pd,
                             opt_g=opt.init(pg), opt_d=opt.init(pd),
                             lr=jnp.asarray(JCFG.train.learning_rate, jnp.float32))


def _port_step(ranks, cfg, noise):
    """The port's single-process step on the global batch."""
    st = ranks["step"]
    state = ttrain.init_state(cfg, st["params_g"], st["params_d"], device="cpu",
                              disc_width_div=DIV)
    m = ttrain.make_train_step(cfg, DIV)(state, ttrain.Batch(**ranks["batch"]).to("cpu"),
                                         noise=noise, keep_grads=True)
    return m, state


LOSSES = ("loss_g", "loss_d", "loss_mel", "loss_kl", "loss_fm", "loss_adv")


def test_sharded_step_matches_jax_sharded_step(ranks):
    """Two ranks against JAX's make_sharded_train_step on a 2-device mesh,
    the ranks' KL mask sums differing: every loss term within rtol 2e-4,
    every gradient leaf within 1e-3 x its max |g| (JAX's gradients read
    from its AdamW state), the gradient norms within 1e-3."""
    r0, jax_ref = ranks["outs"][0]["step"]["jax_noise"], ranks["jax"]
    jm = jax_ref["step"]
    for k in LOSSES:
        np.testing.assert_allclose(r0["metrics"][k], jm[k], rtol=2e-4, err_msg=k)
    assert_grads_close(r0["grads_g"], jax_ref["grads_g"], "G")
    assert_grads_close(r0["grads_d"], jax_ref["grads_d"], "D")
    for k in ("grad_norm_g", "grad_norm_d"):
        np.testing.assert_allclose(r0["metrics"][k], jm[k], rtol=1e-3, err_msg=k)


@pytest.mark.parametrize("case", ["jax_noise", "drawn"])
def test_sharded_step_matches_one_process(ranks, case):
    """Two ranks against the port's one-process step on the global batch,
    on JAX's draws and on the generator's: losses within rtol 2e-4, each
    gradient leaf within 1e-3 x its max |g|; the ranks' gradients and
    updated parameters bitwise equal."""
    r0, r1 = (o["step"][case] for o in ranks["outs"])
    m, state = _port_step(ranks, TCFG, ranks["draws"] if case == "jax_noise" else None)
    for k in LOSSES:
        np.testing.assert_allclose(r0["metrics"][k], float(m[k]), rtol=2e-4, err_msg=k)
        assert r0["metrics"][k] == r1["metrics"][k]
    assert_grads_close(r0["grads_g"], m["grads_g"], "G")
    assert_grads_close(r0["grads_d"], m["grads_d"], "D")
    for a, b in zip(r0["grads_g"] + r0["grads_d"], r1["grads_g"] + r1["grads_d"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(r0["params"], r1["params"])


def test_sharded_step_bf16_checkpointed_tracks_one_process(ranks):
    """bf16 with checkpointed forwards: two ranks against one process, at
    the JAX bf16 tests' gates (losses within 0.1 relative, the G gradient
    norm within 0.25)."""
    r0 = ranks["outs"][0]["step"]["bf16_remat"]
    cfg = dataclasses.replace(TCFG, train=dataclasses.replace(TCFG.train, bf16=True,
                                                              remat=True))
    m, _ = _port_step(ranks, cfg, None)
    for k in ("loss_g", "loss_d", "loss_mel", "loss_kl", "grad_norm_g"):
        ref = float(m[k])
        tol = 0.25 if k == "grad_norm_g" else 0.1
        assert abs(r0["metrics"][k] - ref) <= tol * max(abs(ref), 1e-6), (k, ref)


def test_noise_draws_are_the_global_batch_rows():
    """A rank's draws are its rows of the global batch's draws."""
    from rvc_maker_tpu_torch.models import synthesizer as tsyn

    spec, lengths = torch.zeros(B, T, 129), torch.tensor([T, T, SEG + 1, T - 3])
    full = tsyn.train_noise(TCFG.model, spec, lengths, torch.Generator().manual_seed(3))
    for r in range(WORLD):
        rows = tmesh.rows_of(B, r, WORLD)
        part = tsyn.train_noise(TCFG.model, spec[rows], lengths[rows],
                                torch.Generator().manual_seed(3), rows=rows, n_rows=B)
        for k in ("post_noise", "ids_slice"):
            assert torch.equal(part[k], full[k][rows]), k
        assert torch.equal(part["dec_noise"]["sine"], full["dec_noise"]["sine"][rows])


# -- batches and train() -------------------------------------------------------

def test_batches_for_epoch_rows_match_jax(ranks):
    b = ranks["batches"]
    ds = jdata.TrainingDataset(b["filelist"], JCFG)
    for r, out in enumerate(ranks["outs"]):
        ref = list(jdata.batches_for_epoch(ds, batch_size=b["batch_size"], epoch=b["epoch"],
                                           seed=b["seed"], rank=r, num_replicas=WORLD))
        got = out["batches"]
        assert len(got) == len(ref) == N_ITEMS // b["batch_size"]
        for g, j in zip(got, ref):
            for field in ("phone", "phone_lengths", "pitch", "pitchf", "spec",
                          "spec_lengths", "wave", "sid"):
                np.testing.assert_array_equal(g[field], getattr(j, field), err_msg=field)
            assert g["spec"].shape[1] == 200    # pinned to the bucket bound


def test_train_across_ranks(ranks):
    """train() on two ranks: only rank 0 writes, the parameters are
    bitwise equal on both ranks after each run, a resumed second epoch
    equals two epochs straight, and one process that loads the checkpoint
    holds the ranks' state."""
    (o0, o1), tr = (o["train"] for o in ranks["outs"]), ranks["train"]
    assert o1["writes"] == []
    steps = N_ITEMS // (ITEM_BATCH * WORLD)
    assert (o0["a1"]["step"], o0["a2"]["step"], o0["c"]["step"]) == (steps, 2 * steps,
                                                                       2 * steps)
    for run in ("a1", "a2", "c"):
        np.testing.assert_array_equal(o0[run]["params"], o1[run]["params"])
    np.testing.assert_array_equal(o0["a2"]["params"], o0["c"]["params"])
    files = sorted(os.listdir(tr["exp_a"]))
    assert files == sorted(["filelist.txt", "ckpt_latest.pt", "training_data.json", "tb",
                            f"exp_a_1e_{steps}s.pth", f"exp_a_2e_{2 * steps}s.pth"])
    state = ttrain.init_state(TCFG, device="cpu", disc_width_div=DIV)
    assert tloop.load_checkpoint(os.path.join(tr["exp_a"], tloop.LATEST), state) == 2
    flat = torch.cat([t.detach().reshape(-1) for t in ttrain.tree_leaves(state.params_g)
                      + ttrain.tree_leaves(state.params_d)]).numpy()
    np.testing.assert_array_equal(flat, o0["a2"]["params"])


# -- sharded conversion ------------------------------------------------------

def _port_pipe(ranks):
    c = ranks["convert"]
    return ConvertPipeline(c["synth"], c["cfg"], c["hubert"], version="v2",
                           index_vectors=c["index"], device="cpu",
                           max_device_batch=c["max_device_batch"])


@pytest.mark.parametrize("case", ["even", "odd"])
def test_sharded_convert_matches_jax_mesh_and_one_process(ranks, case):
    """An even batch and an odd one (padded by a repeated row): every
    rank's waveform against JAX's mesh conversion and against one
    process, rtol 1e-3 / atol 2e-4; pitchf within 1e-2 Hz of JAX's."""
    c = next(x for x in ranks["convert"]["cases"] if x["name"] == case)
    ref_j, pf_j = ranks["jax"]["convert"][case]
    one, _ = _port_pipe(ranks).convert_batch(
        c["audio"], c["lengths"], 0, ConvertSettings(**CONVERT_SETTINGS),
        z_noise=torch.as_tensor(c["z"]), noise={"sine": torch.as_tensor(c["noise"]["sine"])})
    assert np.abs(n(ref_j)).max() > 0.01
    for out in ranks["outs"]:
        wav, pf, _ = out["convert"][case]
        assert wav.shape == n(ref_j).shape == n(one).shape
        np.testing.assert_allclose(wav, n(ref_j), rtol=1e-3, atol=2e-4)
        np.testing.assert_allclose(wav, n(one), rtol=1e-3, atol=2e-4)
        np.testing.assert_allclose(pf, n(pf_j), atol=1e-2)


def test_sharded_convert_draws_the_one_process_noise(ranks):
    """Without given noise the ranks draw what one process draws for the
    whole batch (two microbatches here), so their rows equal its rows."""
    c = next(x for x in ranks["convert"]["cases"] if x["name"] == "drawn")
    one, pf1 = _port_pipe(ranks).convert_batch(c["audio"], c["lengths"], 0,
                                               ConvertSettings(**CONVERT_SETTINGS))
    for out in ranks["outs"]:
        wav, pf, _ = out["convert"]["drawn"]
        np.testing.assert_allclose(wav, n(one), rtol=1e-3, atol=2e-4)
        np.testing.assert_array_equal(pf, n(pf1))


# -- sharded retrieval and tensor-parallel HuBERT ------------------------------

@pytest.mark.parametrize("i", [0, 1])
def test_sharded_blend_matches_jax(ranks, i):
    """Case 1 has 101 rows: rank 1's shard ends with a sentinel row."""
    c, ref = ranks["blend"][i], ranks["jax"]["blend"][i]
    one = n(retrieval_blend(torch.as_tensor(c["feats"]), torch.as_tensor(c["vectors"]),
                            c["rate"], k=c["k"]))
    for out in ranks["outs"]:
        np.testing.assert_allclose(out["blend"][i], ref, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out["blend"][i], one, rtol=1e-4, atol=1e-5)


def test_tp_spec_assignment():
    spec = ttensor.hubert_tp_spec
    assert spec(("layers", "0", "attn", "q", "w")) == 0
    assert spec(("layers", "3", "attn", "v", "b")) == 0
    assert spec(("layers", "0", "fc1", "w")) == 0
    assert spec(("layers", "0", "attn", "o", "w")) == 1
    assert spec(("layers", "0", "fc2", "w")) == 1
    assert spec(("layers", "0", "fc2", "b")) is None
    assert spec(("layers", "0", "ln1", "gamma")) is None
    assert spec(("frontend", "convs", "0", "w")) is None
    assert spec(("final_proj", "w")) is None
    lp = ttensor.shard_hubert_tp(from_jax.hubert_from_jax(_hubert_tree(0, 1)), 1, WORLD)[
        "layers"][0]
    assert lp["attn"]["q"]["w"].shape == (384, 768) and lp["attn"]["q"]["b"].shape == (384,)
    assert lp["attn"]["o"]["w"].shape == (768, 384) and lp["attn"]["o"]["b"].shape == (768,)
    assert lp["fc1"]["w"].shape == (1536, 768) and lp["fc2"]["w"].shape == (768, 1536)


@pytest.mark.parametrize("version", ["v2", "v1"])
def test_tp_hubert_matches_jax(ranks, version):
    """12 heads split 6 / 6 and the FFN 1536 / 1536 in each of 2 layers
    (full width; the card runs all 12), against JAX's tp_extract_features
    on a 1 x 2 (data x model) mesh and the port's whole-model
    extract_features: rtol 2e-3 / atol 2e-4."""
    c = next(x for x in ranks["tp"] if x["version"] == version)
    ref = ranks["jax"]["tp"][version]
    with torch.inference_mode():
        one, _ = thubert.extract_features(c["params"], torch.as_tensor(c["audio"]),
                                          torch.as_tensor(c["lengths"]),
                                          output_layer=12 if version == "v2" else 9)
        if version == "v1":
            one = thubert.final_proj(c["params"], one)
    for out in ranks["outs"]:
        got = out["tp"][version]
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(got, n(one), rtol=2e-3, atol=2e-4)
