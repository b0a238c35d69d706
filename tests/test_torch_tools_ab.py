"""`rvc_maker_tpu_torch/tools/train_ab_overlay.py` --cpu at the narrow size
of tests/test_torch_tools.py, whose __main__ is the CLI it drives."""

import json

import numpy as np

from test_torch_tools import narrow_tools  # noqa: F401
from torch_port_util import torch_threads  # noqa: F401


def test_train_ab_overlay_cpu(tmp_path, narrow_tools):
    """2 arms x 2 epochs: JAX's keys, and the bf16 spec moves the first
    epoch's loss_g."""
    _, overlay = narrow_tools
    wd = tmp_path / "ab"
    out = overlay.main(["--workdir", str(wd), "--files", "2", "--epochs", "2",
                        "--batch-size", "2", "--cpu"])
    saved = json.loads((wd / "overlay.json").read_text())
    for key in ("metric", "env", "points_compared", "loss_g_tail_base",
                "loss_g_tail_variant", "tail_delta", "tail_rel", "both_decreasing",
                "base", "variant"):
        assert key in saved
    assert saved["env"] == "RVC_TPU_BF16_SPEC=1" and saved["points_compared"] >= 1
    base, var = out["base"]["epoch_loss_g"], out["variant"]["epoch_loss_g"]
    assert len(base) == len(var) == 2 and np.isfinite(base + var).all()
    assert base[0] != var[0]
