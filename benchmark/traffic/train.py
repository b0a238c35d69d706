"""Training, closed loop: the step of the port's `make_train_step` back to
back on one state, fp32 with TF32 off, each batch `batch_size` clips
whose lengths are drawn from the seed between `clip_min_s` and
`clip_max_s` and padded to the batch's longest; the step's noise given
(`noise=`).

Set-up builds the state (the generator with its posterior encoder, the
discriminators, both AdamW states) from the seed and drives it through
its first `pool` steps, one per batch of the pool, through the window's
own call: the first `checked_steps` are the ones the reference follows,
the rest warm the pool's other shapes.  The longest clip of the pool's
batches runs over a fixed ladder from `clip_min_s` + a quarter of the
span up to `clip_max_s`, in an order drawn from the seed, so every seed
trains the same set of shapes.

Parameters: batch_size, pool, clip_min_s, clip_max_s, checked_steps,
limits.
"""

from __future__ import annotations

import math
import random
import time

import torch

from benchmark import convert_common as cc
from benchmark import roofline, weights
from benchmark.reference import convert as ref_convert
from benchmark.reference import stft as ref_stft
from benchmark.reference import train as ref_train

RANGES = ("train.g_forward", "train.d_step", "train.g_loss", "train.g_backward",
          "train.optim")


def _program_cfg(config: dict):
    from rvc_maker_tpu_torch.config import DataConfig, ModelConfig, RVCConfig, TrainConfig

    m = {k: (tuple(tuple(x) if isinstance(x, list) else x for x in v) if isinstance(v, list)
             else v) for k, v in config["model"].items()}
    t = config["train"]
    train = TrainConfig(learning_rate=t["learning_rate"], betas=tuple(t["betas"]),
                        eps=t["eps"], lr_decay=t["lr_decay"], segment_size=t["segment_size"],
                        c_mel=t["c_mel"], c_kl=t["c_kl"])
    return RVCConfig(version=config["version"], train=train, data=DataConfig(**config["data"]),
                     model=ModelConfig(**m))


def _batches(ctx) -> tuple[list, list]:
    """The pool's batches and each one's step noise, on the device."""
    p, c, dev = ctx.params, ctx.config, ctx.device
    data, model, train = c["data"], c["model"], c["train"]
    sr, hop, b = data["sample_rate"], data["hop_length"], p["batch_size"]
    seg_frames = train["segment_size"] // hop
    upp = math.prod(model["upsample_rates"])
    rng = random.Random(ctx.seed * 13 + 1)
    lo, hi = p["clip_min_s"], p["clip_max_s"]
    ladder = [lo + (hi - lo) * (0.25 + 0.75 * i / max(p["pool"] - 1, 1))
              for i in range(p["pool"])]
    rng.shuffle(ladder)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed % (2 ** 63) + 17)
    batches, noises = [], []
    for longest in ladder:
        secs = [longest] + [rng.uniform(lo, longest) for _ in range(b - 1)]
        frames = [int(s * sr) // hop for s in secs]
        t = max(frames)
        wave16 = cc.voices(b, [f * hop / sr for f in frames], gen, dev)
        # the voices are drawn at 16 kHz; resample them to the model's rate
        wave = torch.nn.functional.interpolate(wave16[:, None], size=t * hop,
                                               mode="linear")[:, 0]
        wave = wave * (torch.arange(t * hop, device=dev)[None, :]
                       < torch.tensor(frames, device=dev)[:, None] * hop)
        spec = ref_stft.spectrogram(wave, n_fft=data["filter_length"], hop_length=hop,
                                    win_length=data["win_length"])[:, :t]
        tt = torch.arange(t, device=dev, dtype=torch.float32) / 100.0
        base = 100.0 + 250.0 * torch.rand((b, 1), generator=gen, device=dev)
        pitchf = base * (1 + 0.03 * torch.sin(2 * math.pi * 5.0 * tt))
        pitchf = pitchf * (torch.rand((b, t), generator=gen, device=dev) > 0.1)
        lengths = torch.tensor(frames, device=dev)
        batches.append({
            "phone": torch.randn((b, t, model["text_enc_hidden_dim"]), generator=gen,
                                 device=dev),
            "phone_lengths": lengths, "pitch": ref_convert.coarse_f0(pitchf),
            "pitchf": pitchf, "spec": spec, "spec_lengths": lengths,
            "wave": wave[:, :, None],
            "sid": torch.randint(0, model["spk_embed_dim"], (b,), generator=gen, device=dev)})
        u = torch.rand(b, generator=gen, device=dev)
        noises.append({
            "post_noise": torch.randn((b, t, model["inter_channels"]), generator=gen,
                                      device=dev),
            "ids_slice": (u * (lengths - seg_frames + 1)).to(torch.int32),
            "dec_noise": {"sine": torch.randn((b, seg_frames * upp, 1), generator=gen,
                                              device=dev)}})
    return batches, noises


def _leaf_norms(tensors) -> torch.Tensor:
    return torch.stack([t.detach().double().norm() for t in tensors])


def _first_grads(opt, leaves, beta1: float) -> torch.Tensor:
    """Each leaf's first gradient norm as AdamW holds it after one step:
    exp_avg = (1 - beta1) g (0 for a leaf the optimizer never stepped)."""
    return _leaf_norms([opt.state[x]["exp_avg"] / (1 - beta1) if x in opt.state
                        else torch.zeros_like(x) for x in leaves]).cpu()


def setup(ctx) -> None:
    from rvc_maker_tpu_torch.pipelines import train as ptrain

    p, c, dev = ctx.params, ctx.config, ctx.device
    cfg = _program_cfg(c)
    params_g = weights.materialize(weights.synthesizer_spec(c["model"], train=True),
                                   ctx.seed * 4 + 1, dev)
    params_d = weights.materialize(weights.discriminator_spec(c["version"]),
                                   ctx.seed * 4 + 2, dev)
    st = ctx.state
    st["init"] = (weights.to_host(params_g), weights.to_host(params_d))
    st["batches"], st["noises"] = _batches(ctx)
    state = ptrain.init_state(cfg, params_g, params_d, device=dev, seed=ctx.seed % (2 ** 31))
    del params_g, params_d
    step = ptrain.make_train_step(cfg)
    b1 = cfg.train.betas[0]
    losses = []
    for k in range(p["pool"]):
        m = step(state, ptrain.Batch(**st["batches"][k]), noise=st["noises"][k])
        if k < p["checked_steps"]:
            losses.append((float(m["loss_g"]), float(m["loss_d"])))
        if k == 0:
            st["grad1"] = [_first_grads(opt, ptrain.tree_leaves(tree), b1)
                           for opt, tree in ((state.opt_g, state.params_g),
                                             (state.opt_d, state.params_d))]
        if k + 1 == p["checked_steps"]:
            st["update"] = [
                _leaf_norms([x.detach() - y.to(dev) for x, y in zip(
                    ptrain.tree_leaves(tree), ref_train.leaves(init))]).cpu()
                for tree, init in ((state.params_g, st["init"][0]),
                                   (state.params_d, st["init"][1]))]
    st.update(losses=losses, state=state, step=step, batch_cls=ptrain.Batch)


def window(ctx, seconds: float) -> dict:
    st, p = ctx.state, ctx.params
    state, step, batch_cls = st["state"], st["step"], st["batch_cls"]
    batches = [batch_cls(**b) for b in st["batches"]]
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        j = n % p["pool"]
        step(state, batches[j], noise=st["noises"][j])
        n += 1
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    m = ctx.config["model"]
    seg_frames = ctx.config["train"]["segment_size"] // ctx.config["data"]["hop_length"]
    shapes = roofline.resblock_launch_shapes(m, p["batch_size"], seg_frames)
    work = {"steps": n, "resblock_shapes": shapes * n, "resblock_dtype": "float32",
            "dtype": "float32", "order": [k % p["pool"] for k in range(n)]}
    return {"metrics": {"train_steps_per_s": n / dt}, "attempted": n, "failed": 0,
            "work": work, "ranges": RANGES}


def trace_work(ctx, work: dict) -> None:
    """The model's operations in the traced window: the reference's step
    on each batch's shapes, counted once per shape."""
    per = {}
    for j in set(work["order"]):
        per[j] = roofline.train_flops(ctx.config, ctx.state["batches"][j],
                                      ctx.state["noises"][j])
    work["model_flops"] = sum(per[j] for j in work["order"])


def free(ctx) -> None:
    for key in ("state", "step", "batch_cls"):
        ctx.state.pop(key, None)


def reference_steps(ctx, tf32: bool) -> dict:
    """The reference's first `checked_steps` steps from the initial
    weights, on the same batches and noise: the losses, the first step's
    gradient norms per leaf, the parameters' change per leaf."""
    st, p, c, dev = ctx.state, ctx.params, ctx.config, ctx.device
    cfg = ref_convert.model_cfg(c["model"])
    cfg.segment_size = c["train"]["segment_size"] // c["data"]["hop_length"]
    init_g, init_d = st["init"]
    pg = ref_train.trainable(weights.to_device(init_g, dev))
    pd = ref_train.trainable(weights.to_device(init_d, dev))
    og, od = ref_train.optimizer(pg, c["train"]), ref_train.optimizer(pd, c["train"])
    losses, grad1 = [], None
    with cc.tf32(tf32):
        for k in range(p["checked_steps"]):
            out = ref_train.step(cfg, c["data"], c["train"], pg, pd, og, od,
                                 st["batches"][k], st["noises"][k])
            losses.append((float(out["loss_g"]), float(out["loss_d"])))
            if k == 0:
                grad1 = [_leaf_norms(out["grads_g"]).cpu(), _leaf_norms(out["grads_d"]).cpu()]
            del out
    update = [_leaf_norms([x.detach() - y.to(dev) for x, y in zip(
        ref_train.leaves(tree), ref_train.leaves(init))]).cpu()
        for tree, init in ((pg, init_g), (pd, init_d))]
    return {"losses": losses, "grad1": grad1, "update": update}


def _worst_leaf(got: list, ref: list, grad_ref: list | None = None) -> float:
    """The widest gap between two norms of a leaf, over the larger of the
    reference's norm of that leaf and its median leaf's; with grad_ref,
    leaves whose reference gradient is under a thousandth of the median
    leaf's are left out (they move by round-off alone under Adam)."""
    worst = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        keep = torch.ones_like(r, dtype=torch.bool)
        if grad_ref is not None:
            keep = grad_ref[i] >= 1e-3 * grad_ref[i].median()
        scale = torch.clamp(r, min=float(r.median()))
        gap = ((g - r).abs() / scale)[keep]
        if gap.numel():
            worst = max(worst, float(gap.max()))
    return worst


def judge(ctx, got: dict) -> list:
    ref = reference_steps(ctx, tf32=False)
    loss = max(abs(a - b) / abs(b) for pg, pr in zip(got["losses"], ref["losses"])
               for a, b in zip(pg, pr))
    lim = ctx.params["limits"]
    return [("loss_gap", loss, lim["loss_gap"]),
            ("grad_gap", _worst_leaf(got["grad1"], ref["grad1"]), lim["grad_gap"]),
            ("update_gap", _worst_leaf(got["update"], ref["update"], ref["grad1"]),
             lim["update_gap"])]


def check(ctx) -> list:
    st = ctx.state
    return judge(ctx, {"losses": st["losses"], "grad1": st["grad1"], "update": st["update"]})


def control(ctx) -> list:
    """The control: the reference with TF32 on in the program's place,
    judged as the program is."""
    c, dev = ctx.config, ctx.device
    st = ctx.state
    st["init"] = (weights.to_host(weights.materialize(
        weights.synthesizer_spec(c["model"], train=True), ctx.seed * 4 + 1, dev)),
        weights.to_host(weights.materialize(weights.discriminator_spec(c["version"]),
                                            ctx.seed * 4 + 2, dev)))
    st["batches"], st["noises"] = _batches(ctx)
    return judge(ctx, reference_steps(ctx, tf32=True))
