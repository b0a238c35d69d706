"""The port's serving internals on the CPU: the dynamic batcher
(`app/batcher.py`, the four JAX `tests/test_batcher.py` tests and
`_valid_out_samples` against JAX's), the warm-up (`utils/warmup.py`,
JAX `tests/test_warmup.py`'s stub coverage and `parse_warm_spec`, and a
failing warm pass that raises) and the profiling helpers
(`utils/profiling.py`)."""

import dataclasses
import logging
import threading

import jax
import numpy as np
import pytest
import torch

from rvc_maker_tpu.config import ModelConfig as JaxModelConfig
from rvc_maker_tpu.models import hubert as jax_hubert
from rvc_maker_tpu.models import synthesizer as jax_syn
from rvc_maker_tpu_torch.app.batcher import ConvertBatcher, _valid_out_samples
from rvc_maker_tpu_torch.config import ModelConfig
from rvc_maker_tpu_torch.interop import from_jax
from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline, ConvertSettings
from rvc_maker_tpu_torch.utils.warmup import parse_warm_spec, warm_pipeline
from torch_port_util import n, torch_threads, tree_np  # noqa: F401

JCFG = JaxModelConfig(
    spec_channels=129, segment_size=8, inter_channels=32, hidden_channels=32,
    filter_channels=64, n_heads=2, n_layers=1, kernel_size=3,
    resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
    upsample_rates=(4, 4, 2, 2), upsample_initial_channel=32,
    upsample_kernel_sizes=(8, 8, 4, 4), spk_embed_dim=4, gin_channels=16,
    sr=6400, use_f0=True, text_enc_hidden_dim=768)
CFG = ModelConfig(**dataclasses.asdict(JCFG))
BATCH_TOL = 2e-3          # JAX test_batcher_matches_direct


@pytest.fixture(scope="module")
def pipeline():
    """JAX test_batcher.py's weights (init_params from PRNGKey(0), a
    2-layer HuBERT from PRNGKey(1)), carried into the port on the CPU."""
    params = jax_syn.init_params(jax.random.PRNGKey(0), JCFG)
    hub = jax_hubert.init_params(jax.random.PRNGKey(1), n_layers=2)
    return ConvertPipeline(from_jax.synthesizer_from_jax(tree_np(params), CFG), CFG,
                           from_jax.hubert_from_jax(tree_np(hub)), version="v2", device="cpu")


def _tone(freq, secs=0.6, sr=16000):
    t = np.arange(int(secs * sr)) / sr
    return (0.3 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _concurrently(fn, args):
    threads = [threading.Thread(target=fn, args=a) for a in args]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)


def test_batcher_matches_direct(pipeline):
    settings = ConvertSettings(f0_method="yin", index_rate=0.0)
    batcher = ConvertBatcher(pipeline, max_batch=8, max_wait_ms=80)
    try:
        freqs = [180.0, 220.0, 260.0, 300.0]
        results, errors = {}, []

        def worker(f):
            try:
                results[f] = batcher.convert(_tone(f), 0, settings, timeout=600)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        _concurrently(worker, [(f,) for f in freqs])
        assert not errors, errors
        audio = np.stack([_tone(f) for f in freqs])
        lengths = np.full((len(freqs),), audio.shape[1], np.int64)
        direct = n(pipeline.convert_batch(audio, lengths, 0, settings)[0])
        upp = pipeline.cfg.upp
        worst = 0.0
        for i, f in enumerate(freqs):
            got = results[f]
            assert got.dtype == np.float32 and got.ndim == 1
            # the padding to a 1 s bucket reaches the last frame of output
            # through the decode's receptive field: excluded, as in JAX
            k = len(got) - upp
            np.testing.assert_allclose(got[:k], direct[i][:k], atol=BATCH_TOL, rtol=BATCH_TOL)
            worst = max(worst, float(np.abs(got[:k] - direct[i][:k]).max()))
            assert np.abs(got[k:]).max() < 0.5
        print(f"\nbatcher vs direct convert_batch: max abs {worst:.3e} (tol {BATCH_TOL})")
    finally:
        batcher.close()


def test_batcher_mixed_lengths_and_sids(pipeline):
    settings = ConvertSettings(f0_method="yin", index_rate=0.0)
    batcher = ConvertBatcher(pipeline, max_batch=8, max_wait_ms=80)
    try:
        specs = [(200.0, 0.5, 0), (240.0, 0.8, 1), (280.0, 0.5, 0)]
        results = {}

        def worker(i, f, secs, sid):
            results[i] = batcher.convert(_tone(f, secs), sid, settings, timeout=600)

        _concurrently(worker, [(i, *s) for i, s in enumerate(specs)])
        assert set(results) == {0, 1, 2}
        ratio = CFG.upp / 160.0
        for i, (f, secs, sid) in enumerate(specs):
            want = int(len(_tone(f, secs)) * ratio)
            assert abs(len(results[i]) - want) <= CFG.upp * 3
            assert np.all(np.isfinite(results[i]))
    finally:
        batcher.close()


def test_batcher_error_propagates(pipeline):
    batcher = ConvertBatcher(pipeline, max_batch=2, max_wait_ms=10)
    try:
        bad = ConvertSettings(f0_method="no-such-method", index_rate=0.0)
        with pytest.raises(ValueError, match="no-such-method"):
            batcher.convert(_tone(220.0, 0.3), 0, bad, timeout=120)
    finally:
        batcher.close()


class _Recorder:
    """The pipeline, with each convert_batch's batch size recorded and
    whether it ran under inference mode."""

    def __init__(self, pipe):
        self._pipe = pipe
        self.batch_sizes, self.inference_mode = [], []

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def convert_batch(self, audio, lengths, sid, settings):
        self.batch_sizes.append(audio.shape[0])
        self.inference_mode.append(torch.is_inference_mode_enabled())
        return self._pipe.convert_batch(audio, lengths, sid, settings)


def test_batcher_pow2_pad_respects_max_batch(pipeline):
    """A non-power-of-two max_batch (3) stays the cap of the device batch;
    the worker runs under inference mode."""
    rec = _Recorder(pipeline)
    batcher = ConvertBatcher(rec, max_batch=3, max_wait_ms=250)
    settings = ConvertSettings(f0_method="yin", index_rate=0.0)
    results = {}

    def call(i, freq):
        results[i] = batcher.convert(_tone(freq, 0.5), 0, settings, timeout=600)

    try:
        _concurrently(call, [(i, 200.0 + 20 * i) for i in range(3)])
    finally:
        batcher.close()
    assert len(results) == 3
    for out in results.values():
        assert np.all(np.isfinite(out))
    assert rec.batch_sizes and max(rec.batch_sizes) <= 3, rec.batch_sizes
    assert all(rec.inference_mode)


def test_batcher_overload_raises():
    """A full queue refuses at once (the server's 503)."""
    from rvc_maker_tpu_torch.app.batcher import BatcherOverloaded

    gate = threading.Event()

    class _Blocked:
        cfg = CFG

        def convert_batch(self, audio, lengths, sid, settings):
            gate.wait(30)
            return torch.zeros(audio.shape[0], 64), None

    batcher = ConvertBatcher(_Blocked(), max_batch=1, max_wait_ms=1, max_queue=1)
    outcomes = []

    def call():
        try:
            outcomes.append(batcher.convert(_tone(200.0, 0.1), 0, ConvertSettings(), timeout=30))
        except BatcherOverloaded as e:
            outcomes.append(e)

    try:
        threads = [threading.Thread(target=call) for _ in range(4)]
        for t in threads:
            t.start()
        while sum(isinstance(o, BatcherOverloaded) for o in outcomes) < 2:
            threading.Event().wait(0.01)
        gate.set()
        for t in threads:
            t.join(30)
    finally:
        gate.set()
        batcher.close()
    assert sum(isinstance(o, BatcherOverloaded) for o in outcomes) >= 2
    assert any(isinstance(o, np.ndarray) for o in outcomes)


def test_valid_out_samples_matches_jax():
    from rvc_maker_tpu.app.batcher import _valid_out_samples as jax_valid

    for upp in (64, 320, 480):
        for n_in in list(range(0, 2000, 7)) + list(range(15990, 16010)) + [48000, 160001]:
            assert _valid_out_samples(n_in, upp) == jax_valid(n_in, upp), (n_in, upp)


class _StubPipe:
    """Records which entry points warm_pipeline runs."""

    rmvpe_params = None

    def __init__(self, fail=False):
        self.batch_shapes, self.utterance_lens, self.fail = [], [], fail

    def convert_batch(self, audio, lengths, sid, settings):
        self.batch_shapes.append(tuple(audio.shape))
        if self.fail:
            raise RuntimeError("resblock fma kernel launch failed")
        return np.zeros((audio.shape[0], 16), np.float32), None

    def convert_utterance(self, audio, sid, settings):
        self.utterance_lens.append(len(audio))
        return np.zeros(16, np.float32)


def test_warm_covers_batch_and_utterance_paths():
    pipe = _StubPipe()
    warm_pipeline(pipe, seconds=(3,), batches=(1, 2), fetch=False)
    assert pipe.batch_shapes == [(1, 48000), (2, 48000)]
    assert pipe.utterance_lens == [48000]


def test_failed_warm_pass_raises():
    """Unlike JAX (which logs and skips), a failed warm pass raises."""
    pipe = _StubPipe(fail=True)
    with pytest.raises(RuntimeError, match="launch failed"):
        warm_pipeline(pipe, seconds=(1,), batches=(1,), fetch=False)
    assert pipe.utterance_lens == []


def test_warm_real_pipeline_on_cpu(pipeline):
    """Both paths of a real pipeline at a 1 s bucket; on the CPU no
    kernel library is loaded."""
    from rvc_maker_tpu_torch.utils.warmup import load_route_kernels

    assert load_route_kernels(pipeline) == []
    assert warm_pipeline(pipeline, ConvertSettings(f0_method="yin"), seconds=(1,),
                         batches=(1, 2)) > 0


@pytest.mark.parametrize("spec", ["3,5", "4x3, 1x10", "", "2x1,7"])
def test_parse_warm_spec_matches_jax(spec):
    from rvc_maker_tpu.utils.warmup import parse_warm_spec as jax_parse

    assert parse_warm_spec(spec) == jax_parse(spec)


def test_profiled_convert_batch_logs_fenced_stages(pipeline, monkeypatch, caplog):
    """RVC_TPU_PROFILE=1: one log line per stage, as JAX
    convert.py:874-927 logs them; off by default."""
    from rvc_maker_tpu_torch.utils.profiling import profiling_enabled

    audio = _tone(220.0, 1.0)[None]
    monkeypatch.delenv("RVC_TPU_PROFILE", raising=False)
    assert not profiling_enabled()
    with caplog.at_level(logging.INFO, logger="rvc_maker_tpu_torch.utils.profiling"):
        pipeline.convert_batch(audio, [16000], 0, ConvertSettings(f0_method="yin"))
    assert not [r for r in caplog.records if "stage " in r.getMessage()]
    monkeypatch.setenv("RVC_TPU_PROFILE", "1")
    assert profiling_enabled()
    with caplog.at_level(logging.INFO, logger="rvc_maker_tpu_torch.utils.profiling"):
        pipeline.convert_batch(audio, [16000], 0, ConvertSettings(f0_method="yin"))
    stages = [r.getMessage().split(":")[0] for r in caplog.records
              if r.getMessage().startswith("stage ")]
    assert stages == ["stage f0", "stage features", "stage synth"], stages


def test_stage_timer_and_torch_trace(tmp_path):
    import json
    import os

    from rvc_maker_tpu_torch.utils.profiling import stage_timer, torch_trace

    with stage_timer("x", "cpu") as t:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert t.ms is not None and t.ms >= 0
    with torch_trace(str(tmp_path)):
        torch.ones(8).sum()
    with open(os.path.join(tmp_path, "trace.json")) as f:
        assert "traceEvents" in json.load(f)
