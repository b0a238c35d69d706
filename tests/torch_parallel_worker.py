"""The rank side of tests/test_torch_parallel.py (gloo ranks on the CPU)
and of the two-rank card tests in tests/test_torch_gpu.py: the port's
parallel paths in spawned ranks.

Imports no JAX (a spawned rank imports only torch and the port).  The
parent writes the inputs with torch.save; each rank joins the process
group through the environment contract of `parallel/distributed.py` (a
file store in the test's tmp dir, so that parallel test workers never
share a port), runs every job, and writes its results to
`rank{r}.pt`.  `join_ranks` raises if any rank fails.
"""

import os

import numpy as np
import torch


def start_ranks(work: str, world: int = 2):
    """Start `rank_main` in `world` spawned processes on `work`/inputs.pt;
    the caller may compute meanwhile, then calls `join_ranks`."""
    import torch.multiprocessing as mp

    return mp.start_processes(rank_main, args=(world, work), nprocs=world, join=False,
                              start_method="spawn")


def join_ranks(ctx, work: str, timeout: float = 600.0) -> list[dict]:
    """Each rank's results.  A rank that raises or exits non-zero fails
    the call (torch.multiprocessing re-raises its error); so does one
    still running after `timeout` seconds, which is killed."""
    import time

    deadline = time.monotonic() + timeout
    while not ctx.join(5.0):       # raises when a rank failed
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"ranks still running after {timeout} s")
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(len(ctx.processes))]


def rank_main(rank: int, world: int, work: str) -> None:
    os.environ.update(RVC_COORDINATOR_ADDRESS=f"file://{os.path.join(work, 'store')}",
                      RVC_NUM_PROCESSES=str(world), RVC_PROCESS_ID=str(rank))
    torch.set_num_threads(2)
    from rvc_maker_tpu_torch.device import use_full_fp32
    from rvc_maker_tpu_torch.parallel import distributed as dist_mod

    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    inputs.setdefault("device", "cpu")
    # on the card: full fp32 and deterministic cuDNN algorithms, as the
    # parent's one-process reference runs
    use_full_fp32(torch.device(inputs["device"]))
    torch.backends.cudnn.deterministic = True
    assert dist_mod.ensure_initialized(inputs["device"])
    assert (dist_mod.process_index(), dist_mod.process_count()) == (rank, world)
    out = {}
    try:
        for name, job in JOBS.items():
            if name in inputs:
                out[name] = job(inputs[name], inputs["device"])
    finally:
        dist_mod.shutdown()
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))


def _flat(tensors) -> np.ndarray:
    return torch.cat([t.detach().reshape(-1).float() for t in tensors]).cpu().numpy()


def _tc_launches() -> int:
    from rvc_maker_tpu_torch.ops import resblock as rb

    return rb.resblock_tc_launches


def _step(inp, device):
    """One sharded train step on this rank's rows; `noise` (global) as
    given, or drawn from the state's generator."""
    from rvc_maker_tpu_torch.parallel import distributed as dist_mod
    from rvc_maker_tpu_torch.parallel.mesh import shard_leading
    from rvc_maker_tpu_torch.pipelines import train as tr

    dev = dist_mod.rank_device(device)
    out = {}
    for case in inp["cases"]:
        cfg = case["cfg"]
        state = tr.init_state(cfg, inp["params_g"], inp["params_d"], device=dev,
                              disc_width_div=inp["div"])
        batch = shard_leading(tr.Batch(**case["batch"])).to(dev)
        noise = case["noise"] and {k: {kk: vv.to(dev) for kk, vv in v.items()}
                                   if isinstance(v, dict) else v.to(dev)
                                   for k, v in case["noise"].items()}
        before = _tc_launches()
        m = tr.make_sharded_train_step(cfg, inp["div"])(state, batch, noise=noise,
                                                        keep_grads=True)
        out[case["name"]] = dict(
            metrics={k: float(v) for k, v in m.items() if not k.startswith("grads")},
            grads_g=[g.cpu().numpy() for g in m["grads_g"]],
            grads_d=[g.cpu().numpy() for g in m["grads_d"]],
            params=_flat(tr.tree_leaves(state.params_g) + tr.tree_leaves(state.params_d)),
            resblock_tc_launches=_tc_launches() - before)
    return out


def _batches(inp, device):
    """This rank's batches of one epoch."""
    from rvc_maker_tpu_torch.parallel import distributed as dist_mod
    from rvc_maker_tpu_torch.pipelines import data as data_mod

    ds = data_mod.TrainingDataset(inp["filelist"], inp["cfg"])
    return [vars(b) for b in data_mod.batches_for_epoch(
        ds, batch_size=inp["batch_size"], epoch=inp["epoch"], seed=inp["seed"],
        rank=dist_mod.process_index(), num_replicas=dist_mod.process_count())]


def _train(inp, device):
    """train() for one epoch then a resumed second in `exp_a`, two epochs
    straight in `exp_c`; rank 1 counts the loop's writer calls."""
    from rvc_maker_tpu_torch.parallel import distributed as dist_mod
    from rvc_maker_tpu_torch.pipelines import tb_logging
    from rvc_maker_tpu_torch.pipelines import train as tr
    from rvc_maker_tpu_torch.pipelines import train_loop

    writes = []
    if dist_mod.process_index() != 0:
        def counted(name, fn):
            def wrapper(*a, **kw):
                writes.append(name)
                return fn(*a, **kw)
            return wrapper

        train_loop.save_checkpoint = counted("save_checkpoint", train_loop.save_checkpoint)
        train_loop.export_synthesizer_pth = counted("export_synthesizer_pth",
                                                    train_loop.export_synthesizer_pth)
        det = train_loop.OvertrainingDetector
        det.save_json = counted("save_json", det.save_json)
        tb_logging.TensorBoardLogger = counted("TensorBoardLogger",
                                               tb_logging.TensorBoardLogger)

    def run(exp, epochs):
        state = train_loop.train(exp, inp["cfg"], total_epochs=epochs,
                                 batch_size=inp["batch_size"], save_every_epoch=1,
                                 device=device, disc_width_div=inp["div"])
        return dict(step=state.step, lr=state.lr, params=_flat(
            tr.tree_leaves(state.params_g) + tr.tree_leaves(state.params_d)))

    return dict(a1=run(inp["exp_a"], 1), a2=run(inp["exp_a"], 2), c=run(inp["exp_c"], 2),
                writes=writes)


def _convert(inp, device):
    from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline, ConvertSettings
    from rvc_maker_tpu_torch.parallel import distributed as dist_mod

    pipe = ConvertPipeline(inp["synth"], inp["cfg"], inp["hubert"], version="v2",
                           index_vectors=inp["index"], device=device, sharded=True,
                           max_device_batch=inp["max_device_batch"])
    assert pipe.device == dist_mod.rank_device(device)
    settings = ConvertSettings(**inp["settings"])
    out = {}
    for case in inp["cases"]:
        before = _tc_launches()
        wav, pf = pipe.convert_batch(case["audio"], case["lengths"], 0, settings,
                                     z_noise=case.get("z"), noise=case.get("noise"))
        out[case["name"]] = (wav.cpu().numpy(), pf.cpu().numpy(), _tc_launches() - before)
    return out


def _blend(inp, device):
    from rvc_maker_tpu_torch.parallel.retrieval import shard_index_rows, sharded_retrieval_blend

    return [sharded_retrieval_blend(torch.as_tensor(c["feats"]), shard_index_rows(c["vectors"]),
                                    c["rate"], k=c["k"]).numpy() for c in inp]


def _tp(inp, device):
    from rvc_maker_tpu_torch.parallel.tensor import shard_hubert_tp, tp_extract_features

    out = {}
    for c in inp:
        with torch.inference_mode():
            out[c["version"]] = tp_extract_features(
                shard_hubert_tp(c["params"]), torch.as_tensor(c["audio"]),
                torch.as_tensor(c["lengths"]), version=c["version"]).numpy()
    return out


JOBS = {"step": _step, "batches": _batches, "train": _train, "convert": _convert,
        "blend": _blend, "tp": _tp}
