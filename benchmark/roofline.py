"""The yardstick: the card's published peaks, a resblock launch's
operations and bytes, and the model's operations counted over the plain
reference.

Peaks of one NVIDIA H100 SXM at 700 W (NVIDIA's data sheet, dense, no
sparsity): 495 TFLOP/s for fp32 inputs (TF32 on the tensor cores, the
fastest any fp32-input product runs), 989 TFLOP/s for bf16, 3.35 TB/s of
HBM3.  A roofline counts the algorithm's work once, whatever implements
it: a resblock launch is two dilated convs of C -> C at its k (2 C^2 k
multiply-adds per output sample each), their biases, two leaky ReLUs and
the residual add; its bytes are x read once, the output written once and
both convs' weights and biases read once.
"""

from __future__ import annotations

import functools

PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def resblock_flops(b: int, c: int, t: int, k: int) -> float:
    """Operations of one launch: two C -> C convs of k taps over b x t
    samples, plus 5 elementwise ops per element (2 biases, 2 leaky
    ReLUs, the residual add)."""
    return 2 * (2.0 * b * t * c * c * k) + 5.0 * b * c * t


def resblock_bytes(b: int, c: int, t: int, k: int, dtype: str = "float32") -> float:
    s = DTYPE_BYTES[dtype]
    return s * (2.0 * b * c * t + 2.0 * k * c * c + 2.0 * c)


def launch_bound_s(b, c, t, k, dtype: str = "float32") -> tuple[float, str]:
    """(the least time the card could take, "operations" or "bytes")."""
    ops = resblock_flops(b, c, t, k) / PEAK_FLOPS[dtype]
    by = resblock_bytes(b, c, t, k, dtype) / PEAK_BYTES_PER_S
    return (ops, "operations") if ops >= by else (by, "bytes")


def resblock_launch_shapes(model: dict, rows: int, p_len: int) -> list:
    """(B, C, T, k, dilation) of every launch of one NSF decode of `rows`
    x `p_len` frames: per upsampling stage, per resblock kernel size, one
    launch per dilation."""
    out, t = [], p_len
    for i, u in enumerate(model["upsample_rates"]):
        t *= u
        c = model["upsample_initial_channel"] // 2 ** (i + 1)
        for k, ds in zip(model["resblock_kernel_sizes"], model["resblock_dilation_sizes"]):
            out.extend((rows, c, t, k, d) for d in ds)
    return out


def roofline_share(shapes: list, kernel_ms: list, dtype: str = "float32"):
    """(share, {bound: launches}) of the launches of `shapes` that took
    `kernel_ms` in all, or None when the counts differ (a launch missing
    from the trace, or the kernel off the path)."""
    if not shapes or len(shapes) != len(kernel_ms):
        return None
    bound_s, by = 0.0, {}
    for b, c, t, k, _ in shapes:
        s, which = launch_bound_s(b, c, t, k, dtype)
        bound_s += s
        by[which] = by.get(which, 0) + 1
    return 100.0 * bound_s / (sum(kernel_ms) / 1e3), by


# ---------------------------------------------------------------------------
# model operations, counted over the reference on the meta device
# ---------------------------------------------------------------------------

class _MetaGRU:
    """Stands in for RMVPE's BiGRU on the meta device, where torch steps
    a GRU frame by frame in Python (tens of seconds): its operations by
    formula (two directions, three gates, each a product with the input
    and one with the state), its output as an empty tensor."""

    def __init__(self, n_in: int, hidden: int):
        self.n_in, self.hidden, self.flops = n_in, hidden, 0.0

    def __call__(self, x):
        import torch

        b, t, _ = x.shape
        self.flops += 2 * b * t * 2.0 * 3 * self.hidden * (self.n_in + self.hidden)
        return torch.empty((b, t, 2 * self.hidden), device=x.device), None


def _count(fn, extra=()) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops()) + sum(e.flops for e in extra)


def _meta_models(config: dict):
    import torch

    from . import weights

    def empty(spec):
        return weights._rebuild(spec, {p: torch.empty(leaf.shape, device="meta")
                                       for p, leaf in weights._walk(spec)})
    rp = empty(weights.rmvpe_spec(config["rmvpe"]))
    raw = rp.pop("gru_raw")
    rp["gru"] = _MetaGRU(raw["w_ih"].shape[1], raw["w_hh"].shape[1])
    return {"synth": empty(weights.synthesizer_spec(config["model"])),
            "hubert": empty(weights.hubert_spec(config["hubert"])), "rmvpe": rp,
            "index": torch.empty((config["index"]["rows"], config["index"]["dim"]),
                                 device="meta")}


@functools.lru_cache(maxsize=64)
def _convert_flops(config_json: str, rows: int, samples: int, index_rate: float) -> float:
    import json

    import torch

    from .reference import convert as rc

    config = json.loads(config_json)
    models = _meta_models(config)
    cfg = rc.model_cfg(config["model"])
    p_len = rc.frames(samples)
    audio = torch.empty((rows, samples), device="meta")
    lengths = torch.full((rows,), samples, dtype=torch.int64, device="meta")
    z = torch.empty((rows, p_len, cfg.inter_channels), device="meta")
    sine = torch.empty((rows, p_len * cfg.upp, 1), device="meta")
    pitchf = torch.full((rows, p_len), 200.0, device="meta")

    def run():
        rc.f0(models, audio)
        feats, feats0 = rc.features(models, audio, lengths, index_rate)
        rc.synth(models, cfg, feats, feats0, pitchf, lengths, 0, 0.33, z, sine)
    return _count(run, [models["rmvpe"]["gru"]])


def convert_flops(config: dict, rows: int, samples: int, index_rate: float) -> float:
    import json

    return _convert_flops(json.dumps(config, sort_keys=True), rows, samples, index_rate)


def mfu_percent(flops: float, seconds: float, dtype: str = "float32") -> float | None:
    if not flops or not seconds:
        return None
    return 100.0 * flops / (seconds * PEAK_FLOPS[dtype])


def train_flops(config: dict, batch: dict, noise: dict) -> float:
    """The reference's operations for one training step on `batch`'s
    shapes: the generator's and the discriminators' forwards and both
    backwards (the optimizers' elementwise work is not counted)."""
    import json

    key = (json.dumps(config, sort_keys=True),
           tuple(tuple(v.shape) for v in batch.values()))
    if key not in _TRAIN_CACHE:
        _TRAIN_CACHE[key] = _train_flops(config, batch, noise)
    return _TRAIN_CACHE[key]


_TRAIN_CACHE: dict = {}


class _NoOpt:
    def step(self):
        pass


def _train_flops(config: dict, batch: dict, noise: dict) -> float:
    import torch

    from . import weights
    from .reference import convert as rc
    from .reference import train as rt

    def meta(tree):
        if isinstance(tree, dict):
            return {k: meta(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [meta(v) for v in tree]
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")

    def params(spec):
        return rt.trainable(weights._rebuild(spec, {p: torch.empty(leaf.shape, device="meta")
                                                    for p, leaf in weights._walk(spec)}))
    cfg = rc.model_cfg(config["model"])
    cfg.segment_size = config["train"]["segment_size"] // config["data"]["hop_length"]
    pg = params(weights.synthesizer_spec(config["model"], train=True))
    pd = params(weights.discriminator_spec(config["version"]))
    return _count(lambda: rt.step(cfg, config["data"], config["train"], pg, pd, _NoOpt(),
                                  _NoOpt(), meta(batch), meta(noise)))
