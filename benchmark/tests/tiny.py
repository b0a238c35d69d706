"""A tiny configuration of each cell, for runs on the CPU: every part of
the path at widths a test can hold (the published widths are in
benchmark/configs/)."""

from __future__ import annotations

import copy

from benchmark import harness

MODEL = {"spec_channels": 33, "segment_size": 8, "inter_channels": 8, "hidden_channels": 16,
         "filter_channels": 32, "n_heads": 2, "n_layers": 1, "kernel_size": 3,
         "p_dropout": 0.0, "resblock_kernel_sizes": [3, 7, 11],
         "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
         "upsample_rates": [4, 2, 2], "upsample_initial_channel": 32,
         "upsample_kernel_sizes": [8, 4, 4], "spk_embed_dim": 4, "gin_channels": 8,
         "sr": 1600, "use_f0": True, "text_enc_hidden_dim": 48, "vocoder": "Default",
         "rel_attn_window_size": 10}
CONFIG = {"name": "tiny", "version": "v2", "sample_rate": 1600, "model": MODEL,
          "data": {"max_wav_value": 32768.0, "sample_rate": 1600, "filter_length": 64,
                   "hop_length": 16, "win_length": 64, "n_mel_channels": 20,
                   "mel_fmin": 0.0, "mel_fmax": None},
          "train": {"batch_size": 2, "segment_size": 128, "learning_rate": 1e-4,
                    "betas": [0.8, 0.99], "eps": 1e-9, "weight_decay": 0.01,
                    "lr_decay": 0.999875, "c_mel": 45.0, "c_kl": 1.0},
          "hubert": {"embed_dim": 48, "ffn_dim": 64, "n_heads": 12, "n_layers": 2,
                     "pos_conv_kernel": 128, "pos_conv_groups": 16, "output_layer": 12,
                     "conv_dim": 16},
          "rmvpe": {"widths": [2, 4, 8, 8, 8], "inter_width": 8, "gru_hidden": 4,
                    "n_class": 360, "n_mels": 128},
          "index": {"rows": 64, "dim": 48}}
PARAMS = {
    "v2-48k.convert-batch": {"rows": 2, "seconds": 1.0, "pool": 2, "check_batches": 2},
    "v2-40k.train": {"batch_size": 2, "pool": 3, "clip_min_s": 0.5, "clip_max_s": 0.7,
                     "features_std": 1.0},
    "v2-40k.convert-song": {"song_seconds": [5.0, 3.5], "x_pad": 1, "x_query": 1,
                            "x_center": 2, "x_max": 3},
}


def cell(name: str, **params):
    """The manifest's cell `name` on the tiny configuration, its traffic
    parameters overridden by PARAMS and `params`."""
    c = harness.load_cell(name)
    c.config = copy.deepcopy(CONFIG)
    c.params = {**c.params, **PARAMS.get(name, {}), **params}
    return c
