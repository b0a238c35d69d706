"""Command-line tools of the port, each run as `python -m
rvc_maker_tpu_torch.tools.<name>`:

  e2e_train              a synthetic voiced corpus through cli preprocess,
                         extract, index and train (bf16), a SIGTERM part-way,
                         a resume whose params digest is checked against the
                         checkpoint on disk from another process, and cli
                         convert with the trained weights;
  train_ab_overlay       two training arms, with and without an environment
                         switch (default RVC_TPU_BF16_SPEC=1), and their loss
                         trajectories overlaid;
  int8_gate_rehearsal    log-mel L1 and SNR of int8 against bf16 conversion at
                         each RVC_TPU_INT8_SCOPE, on a trained .pth;
  validate_real_weights  13 checks over a directory of model files, PASS /
                         SKIP / FAIL each, and one summary JSON line.

Each runs on the card unless told otherwise (--cpu, or --device cpu for
the validator).
"""
