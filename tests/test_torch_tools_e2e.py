"""`rvc_maker_tpu_torch/tools/e2e_train.py` run --cpu at the narrow size of
tests/test_torch_tools.py, whose __main__ is the CLI it drives: the
corpus through preprocess, extract, index, train (bf16) with a SIGTERM
part-way, the resume whose logged digest the checkpoint's off-process
digest must equal, and convert.  ~60 s on one worker, most of it the
seven CLI processes' start-up."""

import json

from test_torch_tools import SR, narrow_tools  # noqa: F401
from torch_port_util import torch_threads  # noqa: F401


def test_e2e_train_cpu_run(tmp_path, narrow_tools):
    """4 files x 2 s, 4 epochs at B = 2, SIGTERM once epoch 2 is done: the
    resume's logged digest and step equal the checkpoint's, computed in
    another process; every epoch is done once; the conversion is finite."""
    e2e_train, _ = narrow_tools
    wd = tmp_path / "e2e"
    e2e_train.gen_dataset(str(wd / "dataset"), 4, seconds=2.0)
    args = e2e_train.build_parser().parse_args([
        "run", "--workdir", str(wd), "--files", "4", "--epochs", "4", "--batch-size", "2",
        "--kill-epoch", "2", "--save-every", "2", "--cpu"])
    s = e2e_train.run(args)
    assert json.loads((wd / "SUMMARY.json").read_text()) == s
    assert s["phase_a_rc"] == 0 and s["resume_byte_exact"], s
    assert s["ckpt_step_at_kill"] == s["resume_step"] > 0
    assert s["epochs_done"] == [1, 2, 3, 4]
    # the overtraining detector's history leaves out epoch 1, as JAX's does
    assert s["epochs_logged"] == 3
    assert s["convert_finite"] and s["convert_out_sr"] == SR
    assert abs(s["convert_out_sec"] - 5.0) < 0.1
    assert s["exported_pth"].startswith("e2e_4e_")
    for key in ("ckpt_sha256", "smoothed_g_first", "smoothed_g_last", "g_decreasing",
                "raw_g_first5_mean", "raw_g_last5_mean", "segments", "stages"):
        assert key in s
