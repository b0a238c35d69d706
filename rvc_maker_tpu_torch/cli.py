"""Command line of the PyTorch port: the `convert` subcommand.

    python -m rvc_maker_tpu_torch.cli convert --input in.wav \\
        --output out.wav --model model.pth --rmvpe-path rmvpe.pt \\
        --hubert-path hubert_base.pt [--index feats.npz --index-rate 0.5]
        [--pitch 0 --protect 0.33 --sid 0 --device cuda]

Every weight file is given explicitly; nothing is downloaded.  The run
is on the card unless `--device cpu` is passed.
"""

from __future__ import annotations

import argparse
import os
import sys


def cmd_convert(args) -> int:
    import numpy as np

    from .interop.pth import load_synthesizer_pth
    from .models.hubert import load_hubert_pt
    from .models.rmvpe import load_rmvpe_pt
    from .pipelines.convert import ConvertPipeline, ConvertSettings
    from .retrieval.index import load_index
    from .utils.audio import load_audio, save_wav

    for flag, path in (("--model", args.model), ("--rmvpe-path", args.rmvpe_path),
                       ("--hubert-path", args.hubert_path), ("--input", args.input)):
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{flag}: no such file {path!r}")
    synth_params, cfg, meta = load_synthesizer_pth(args.model)
    index_vectors = None
    if args.index and args.index_rate > 0:
        index_vectors = load_index(args.index).vectors
    pipe = ConvertPipeline(synth_params, cfg, load_hubert_pt(args.hubert_path),
                           version=meta.get("version", "v2"),
                           rmvpe_params=load_rmvpe_pt(args.rmvpe_path),
                           index_vectors=index_vectors, device=args.device)
    settings = ConvertSettings(pitch=args.pitch, index_rate=args.index_rate,
                               protect=args.protect)
    audio = load_audio(args.input, 16000)
    peak = np.abs(audio).max() / 0.95
    if peak > 1:
        audio = audio / peak
    out = pipe.convert_utterance(audio, args.sid, settings)
    save_wav(args.output, out, cfg.sr)
    print(f"wrote {args.output} ({len(out) / cfg.sr:.2f}s @ {cfg.sr} Hz)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="rvc_maker_tpu_torch.cli")
    sub = ap.add_subparsers(dest="command", required=True)
    c = sub.add_parser("convert", help="convert one utterance")
    c.add_argument("--input", required=True)
    c.add_argument("--output", required=True)
    c.add_argument("--model", required=True, help="interchange .pth voice model")
    c.add_argument("--rmvpe-path", required=True, help="reference rmvpe.pt")
    c.add_argument("--hubert-path", required=True,
                   help="fairseq HuBERT/ContentVec .pt")
    c.add_argument("--index", default="", help=".npz index or total_fea.npy")
    c.add_argument("--index-rate", type=float, default=0.5)
    c.add_argument("--pitch", type=int, default=0)
    c.add_argument("--protect", type=float, default=0.33)
    c.add_argument("--sid", type=int, default=0)
    c.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    c.set_defaults(func=cmd_convert)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
