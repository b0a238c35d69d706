"""External f0 files and split-audio conversion: the port's
ConvertPipeline on the CPU against the JAX package's, on
test_torch_convert_f0.py's narrow model and the noise the JAX pipeline
draws: the overwritten frames exact, the waveform <= 1e-3."""

import numpy as np
import pytest
import torch

from rvc_maker_tpu.pipelines.convert import ConvertSettings as JaxSettings
from rvc_maker_tpu.pipelines.convert import convert_split as jax_convert_split
from rvc_maker_tpu_torch.pipelines.convert import ConvertSettings, convert_split
from test_torch_convert_f0 import CFG, WAVE_ATOL, _batch, _compare, pipes, trees  # noqa: F401
from torch_port_util import jax_noise, torch_threads, voice  # noqa: F401


@pytest.mark.parametrize("method", ["yin", "pm"])
def test_f0_file_matches_jax(pipes, tmp_path, method):
    """An external "time,f0" contour overwrites 0.5 s from the end of the
    x_pad pad on: those frames equal JAX's exactly."""
    jax_pipe, port = pipes
    path = tmp_path / "f0.txt"
    tt = np.linspace(0.0, 0.5, 26)
    path.write_text("\n".join(f"{a:.4f},{200.0 + 100.0 * a:.3f}" for a in tt) + "\n")
    audio, lengths = _batch(2.0)
    pf, pf_j = _compare(jax_pipe, port, audio, lengths,
                        dict(f0_method=method, f0_file=str(path)), f"f0_file {method}")
    np.testing.assert_array_equal(pf[:, 100:151], pf_j[:, 100:151])
    np.testing.assert_allclose(pf[0, 100:151], 200.0 + np.arange(51), atol=1e-3)


def test_convert_split_matches_jax(pipes):
    """11 s with a 0.8 s silence after 5.5 s: split into 2 pieces (the split
    keeps at least 5 s per piece), each converted and put back."""
    jax_pipe, port = pipes
    audio = voice(11.0, 190.0, 4)
    audio[88000:100800] = 0.0
    ref = jax_convert_split(jax_pipe, audio, 0, JaxSettings(f0_method="harvest"))
    chunks = []

    def noise_fn(b, p_len):
        chunks.append(p_len)
        z, s = jax_noise(b, p_len, CFG.inter_channels, CFG.upp)
        return torch.as_tensor(z), {"sine": torch.as_tensor(s)}

    got = convert_split(port, audio, 0, ConvertSettings(f0_method="harvest"),
                        noise_fn=noise_fn)
    assert len(chunks) == 2 and got.shape == ref.shape == (11 * CFG.sr,)
    err = float(np.abs(got - ref).max())
    print(f"convert_split: {len(chunks)} pieces, max abs err {err:.3e}")
    assert np.abs(ref).max() > 0.1 and err <= WAVE_ATOL, err
